// The epilogue shared by every kernel of the port: the activation table and
// the conversions between the storage type T (float or bf16) and fp32.
// The grid kernels (ffn_grid.cuh: the dense-grid conv, the LM kernels and
// the walker's grid mode) and the walker's tile mode (walk.cu) flush
// through these, so a work-list schedule and the dense grid give bit for
// bit the same tile when their sums agree.
//
// Epilogue. activate (the table of
// repro_torch.kernels.worklist_core.activate) maps the fp32 accumulator,
// and for the gated acts a second one, before the one rounding at the
// store: one out-of-line activate, the same expf, tanhf and operation order
// everywhere. None and ReLU, the conv kernels' epilogues, stay inline at the
// call sites. Measured on an H100 (PERF.md): activate inlined at every
// element cost an FMA loop in the same kernel 2.4-3.3% (scheduled
// differently), and a call per element for ReLU cost the dense-grid conv 8%
// at VGG16 layer 1, where the epilogue is a large share of a short block.
//
// Storage. bf16 is widened to fp32 exactly and rounded to nearest even once
// at the store; all arithmetic is fp32 either way (for float both
// conversions are the identity).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile {

// Activation codes (repro_torch.kernels.worklist_core.ACT_CODE).
enum Act {
  ACT_NONE = -1,
  ACT_RELU = 0,
  ACT_RELU2 = 1,
  ACT_GELU = 2,
  ACT_SWIGLU = 3,
  ACT_GEGLU = 4
};

__device__ inline float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// act(h) for the one-stream acts; silu(g) * h and gelu(g) * h for the gated
// ones. Every act maps 0 to 0, so a row that is all zero stays exactly zero.
static __device__ __noinline__ float activate(float h, float g, int act) {
  switch (act) {
    case ACT_NONE:
      return h;
    case ACT_RELU:
      return fmaxf(h, 0.f);
    case ACT_RELU2: {
      const float r = fmaxf(h, 0.f);
      return r * r;
    }
    case ACT_GELU:
      return gelu_tanh(h);
    case ACT_SWIGLU:
      return g / (1.f + expf(-g)) * h;
    default:  // ACT_GEGLU
      return gelu_tanh(g) * h;
  }
}

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace tile
