// Fused sparse FFN in-projection (K4): act(x @ W_in [, x @ W_gate]) in one
// launch.
//
// Replaces the TPU kernel repro/kernels/fused_ffn.py:_kernel (pallas_call in
// fused_ffn_spmm), whose skip predicate is
// repro/kernels/bitmask_spmm.py:subblock_macs.
//
// What it computes. W_in and W_gate are chunk-block-sparse with their chunk
// lists aligned on one slot axis (in_idx / gate_idx [nb, max_nz], -1 padded,
// with zero tiles behind every -1). For each (n, m) tile it visits every slot
// j and MACs x[m-block, in_idx[n, j]] @ in_vals[n, j] into the fp32
// accumulator h and, for the gated acts, x[m-block, gate_idx[n, j]] @
// gate_vals[n, j] into a second accumulator g; when two-sided each stream
// skips the sub_m-row sub-blocks whose occupancy bit for its own chunk is 0.
// At the flush it applies the activation in fp32 (relu, relu2, tanh-GELU;
// silu(g) * h for swiglu, gelu(g) * h for geglu: tile::activate, the
// formulas of repro_torch.kernels.worklist_core.activate, shared with the
// walker's flush) and writes the activated hidden tile in the storage type
// of x (fp32, or bf16 rounded to nearest even). Rows that are all zero stay
// exactly zero: every act maps 0 to 0.
//
// Design. The grid of ffn_grid.cuh: one 64-thread CTA per 32-row x 16- or
// 32-column tile of an n-block and stream; for the gated acts a cluster of
// two CTAs, one per stream, each with its own live list (a slot live in one
// stream costs that stream alone) and TMA ring, the gate CTA handing its
// accumulators to the in CTA through distributed shared memory before the
// flush. Each accumulator adds its chunks in ascending j. Nothing is
// carried between tiles and no atomics touch the output, so every row's
// result is independent of the other rows of its block. Row blocks as in
// bitmask_spmm.cu: dividing or a multiple of 32 rows, the last 32-row tile
// possibly partial.
//
// What bounds it on this card. At decode the work is reading the stored
// W_in and W_gate tiles once (bytes: 0.030 ms for Qwen3-4B's bf16 streams
// at 3.35 TB/s). Its 608 busy CTAs (304 pairs) fill every SM with 4 or 5,
// and each thread's 4 chains of 2560 fmaf are fed from shared memory: the
// SMs' shared-load and issue rates, not HBM, set the time. At a 128-token
// prefill the bound is fp32 FMA at 67 TFLOP/s. wgmma on bf16 tiles would
// change the sum order the compact schedule matches bit for bit: later
// work, shared with K1 and K3.
#include "ffn_grid.cuh"

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T>
static int run(const void* x, const void* in_vals, const int* in_idx,
               const void* gate_vals, const int* gate_idx, int* occ,
               void* out, int M, int K, int nb, int max_nz, int bk, int bn,
               int bm_rows, int sub_m, int two_sided, int act, int col_group,
               cudaStream_t st) {
  const bool gated = act == tile::ACT_SWIGLU || act == tile::ACT_GEGLU;
  fgrid::Args<T> a{};
  a.idx[0] = in_idx;
  a.idx[1] = gated ? gate_idx : in_idx;
  a.occ = occ;
  a.out = static_cast<T*>(out);
  a.counts = nullptr;
  a.M = M, a.K = K, a.nb = nb, a.max_nz = max_nz, a.bk = bk, a.bn = bn;
  a.bm = bm_rows, a.sub_m = sub_m, a.two_sided = two_sided, a.act = act;
  a.groups = (bn + col_group - 1) / col_group;
  const T* xt = static_cast<const T*>(x);
  const T* v[2] = {static_cast<const T*>(in_vals),
                   static_cast<const T*>(gated ? gate_vals : in_vals)};
  if (gated) return fgrid::launch<T, true, false>(a, xt, v, col_group, st);
  return fgrid::launch<T, false, false>(a, xt, v, col_group, st);
}

// act: 0 relu, 1 relu2, 2 gelu (tanh), 3 swiglu, 4 geglu; gate_vals and
// gate_idx are read only for 3 and 4. x, the vals and out are fp32
// (bf16 == 0) or bf16 (bf16 == 1); col_group is 16 or 32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fused_ffn_spmm(const void* x, const void* in_vals,
                              const int* in_idx, const void* gate_vals,
                              const int* gate_idx, int* occ, void* out,
                              int M, int K, int nb, int mb, int max_nz,
                              int bk, int bn, int bm_rows, int sub_m,
                              int two_sided, int act, int bf16,
                              int col_group, void* stream) {
  (void)mb;
  if (act < tile::ACT_RELU || act > tile::ACT_GEGLU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(x, in_vals, in_idx, gate_vals, gate_idx, occ,
                              out, M, K, nb, max_nz, bk, bn, bm_rows, sub_m,
                              two_sided, act, col_group, st);
  return run<float>(x, in_vals, in_idx, gate_vals, gate_idx, occ, out, M, K,
                    nb, max_nz, bk, bn, bm_rows, sub_m, two_sided, act,
                    col_group, st);
}
