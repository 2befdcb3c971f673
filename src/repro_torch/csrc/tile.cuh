// The tile core of the walker's 64-row mode (walk.cu): one CUDA block owns
// a 64-row slice of one (n, m) output tile and accumulates it in registers.
// The grid kernels (ffn_grid.cuh: the dense-grid conv, the LM kernels and
// the walker's grid mode) use activate and store from here, with the same
// sum order.
//
// Staging. x and w are staged in shared memory in 32-deep k-slabs
// (64x32 + 32x128 floats = 24 KB, under the 48 KB static limit); 256
// threads each hold a 4-row x TN-column register tile (TN = 4 for bn <= 64,
// 8 for bn <= 128), columns strided by 16 so shared reads and global stores
// are conflict-free and coalesced. The storage type T of x, w and the output
// is float or bf16: bf16 is widened to fp32 when staged and rounded to
// nearest even when stored, and all arithmetic is fp32 either way (for
// float both conversions are the identity).
//
// Sum order. mac_chunk adds one chunk in ascending k with one fmaf per term,
// and the walker calls it once per chunk in ascending j. ffn_grid.cuh adds
// its terms in the same order, so the two give bit for bit the same output
// on the same schedule. (A row the dense grid predicates off would add
// fmaf(0, w, acc) == acc in the walker.)
//
// Epilogue. flush applies activate (the table of
// repro_torch.kernels.worklist_core.activate) to the fp32 accumulator, and
// for the gated acts to a second one, before the one rounding at the store.
// The walker (walk.cu) flushes here and the fused FFN (ffn_grid.cuh) does
// the same operations, so a work-list schedule and the dense grid give bit
// for bit the same hidden tile when their sums agree: one out-of-line
// activate, the same expf, tanhf and operation order. None and ReLU, the
// conv kernels' epilogues, stay inline. Measured on an H100 (PERF.md):
// activate inlined at every element cost an FMA loop in the same kernel
// 2.4-3.3% (scheduled differently), and a call per element for ReLU cost
// the dense-grid conv 8% at VGG16 layer 1, where the epilogue is a large
// share of a short block.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile {

constexpr int RS = 64;        // rows per block: one slice of a row block
constexpr int KS = 32;        // k-slab depth staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads

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

template <int TN>
struct Smem {
  float xs[KS][RS + 1];  // transposed x slab, padded: no bank conflicts
  float ws[KS][16 * TN];
  int row_nz[RS];        // per-row "some output != 0" for the occupancy
};

// Where this block's slice lies, and this thread's place in it.
struct Slice {
  int tid, tx, ty;  // thread, its column lane (0..15) and row group (0..15)
  int rows;         // valid rows of the slice (< RS only at a short block)
  long row_base;    // first row of the slice in x and out
};

__device__ inline Slice slice_of(int m, int bm_rows) {
  Slice s;
  s.tid = threadIdx.x;
  s.tx = s.tid % 16;
  s.ty = s.tid / 16;
  const int r0 = blockIdx.y * RS;
  s.rows = min(RS, bm_rows - r0);
  s.row_base = (long)m * bm_rows + r0;
  return s;
}

template <int TN>
__device__ inline void zero(float (&acc)[4][TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
}

// acc += x[slice rows, bk-chunk at xb] @ w[bk, bn at wb]. Every thread of
// the block must call it: it holds block barriers.
template <int TN, typename T>
__device__ inline void mac_chunk(float (&acc)[4][TN], Smem<TN>& sm,
                                 const Slice& s, const T* xb, const T* wb,
                                 int K, int bk, int bn) {
  constexpr int BN = 16 * TN;
  for (int k0 = 0; k0 < bk; k0 += KS) {
    for (int i = s.tid; i < RS * KS; i += THREADS) {
      const int r = i / KS, c = i % KS;
      sm.xs[c][r] =
          (r < s.rows && k0 + c < bk) ? widen(xb[(long)r * K + k0 + c]) : 0.f;
    }
    for (int i = s.tid; i < KS * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      sm.ws[r][c] =
          (k0 + r < bk && c < bn) ? widen(wb[(long)(k0 + r) * bn + c]) : 0.f;
    }
    __syncthreads();
    const int kn = min(KS, bk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.xs[kk][s.ty * 4 + i];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = sm.ws[kk][s.tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }
}

// Epilogue: act(acc[, acc2]) (activate above; acc2 is read only when
// GATED), write block column n of the slice into out [M, nb*bn] and, with
// emit_occ, occ_out[row / sub_m, n] = any output of those sub_m rows != 0.
// Every thread of the block must call it.
template <int TN, typename T, bool GATED>
__device__ inline void flush(const float (&acc)[4][TN],
                             const float (&acc2)[4][TN], Smem<TN>& sm,
                             const Slice& s, T* out, int* occ_out, int n,
                             int nb, int bn, int sub_m, int act,
                             int emit_occ) {
  if (emit_occ) {
    if (s.tid < RS) sm.row_nz[s.tid] = 0;
    __syncthreads();
  }
  const long ldo = (long)nb * bn;
  const bool inline_act = act == ACT_NONE || act == ACT_RELU;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = s.ty * 4 + i;
    int nz = 0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = s.tx + 16 * c;
      const float h = acc[i][c];
      const float v =
          inline_act ? (act == ACT_RELU ? fmaxf(h, 0.f) : h)
                     : activate(h, GATED ? acc2[i][c] : 0.f, act);
      if (r < s.rows && col < bn) {
        store(out + (s.row_base + r) * ldo + (long)n * bn + col, v);
        nz |= (v != 0.f);
      }
    }
    if (emit_occ && nz) atomicOr(&sm.row_nz[r], 1);
  }
  if (emit_occ) {
    __syncthreads();
    if (s.tid < s.rows / sub_m) {
      int any = 0;
      for (int q = 0; q < sub_m; ++q) any |= sm.row_nz[s.tid * sub_m + q];
      occ_out[(s.row_base / sub_m + s.tid) * nb + n] = any;
    }
  }
}

// The one-accumulator flush (every act but swiglu and geglu).
template <int TN, typename T>
__device__ inline void flush(const float (&acc)[4][TN], Smem<TN>& sm,
                             const Slice& s, T* out, int* occ_out, int n,
                             int nb, int bn, int sub_m, int act,
                             int emit_occ) {
  flush<TN, T, false>(acc, acc, sm, s, out, occ_out, n, nb, bn, sub_m, act,
                      emit_occ);
}

}  // namespace tile
