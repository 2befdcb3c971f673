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
// Design. The block of the dense grid (tile.cuh, as in bitmask_spmm.cu):
// one CUDA block per (n, m, 64-row slice), the j loop inside it, each stream
// a call of tile::grid_slot per slot, so each accumulator adds its chunks in
// ascending j with the skip predicate on its own k. Both accumulators live
// in registers (2 x 4 x TN floats a thread); the gated variant is its own
// instantiation so the non-gated one carries one. Nothing is carried
// between blocks and no atomics touch the output, so every row's result is
// independent of the other rows of its block.
//
// What bounds it on this card. At decode the work is reading the stored
// W_in and W_gate tiles once per live slice (bytes); at a 128-row prefill it
// is fp32 FMA at 67 TFLOP/s. The kernel's time is far from both (PERF.md):
// per slot it stages and widens each tile element by element and pays block
// barriers, and the accumulators double the registers of a thread. wgmma on
// bf16 tiles and TMA staging are later work.
#include "tile.cuh"

namespace {

template <int TN, typename T, bool GATED>
__global__ void __launch_bounds__(tile::THREADS)
fused_ffn_kernel(const T* __restrict__ x, const T* __restrict__ in_vals,
                 const int* __restrict__ in_idx,
                 const T* __restrict__ gate_vals,
                 const int* __restrict__ gate_idx,
                 const int* __restrict__ occ, T* __restrict__ out, int K,
                 int nb, int mb, int max_nz, int bk, int bn, int bm_rows,
                 int sub_m, int two_sided, int act) {
  __shared__ tile::GridSmem<TN> g;
  const int p = blockIdx.x;
  const int n = p / mb, m = p % mb;
  const tile::Slice s = tile::slice_of(m, bm_rows);
  const int kb = K / bk;

  float h[4][TN], gt[4][TN];
  tile::zero(h);
  if constexpr (GATED) tile::zero(gt);
  for (int j = 0; j < max_nz; ++j) {
    const long slot = (long)n * max_nz + j;
    const int ki = in_idx[slot];
    if (ki >= 0)
      tile::grid_slot<TN, T>(h, g, s, x, in_vals + slot * bk * bn, occ, ki, K,
                             kb, bk, bn, sub_m, two_sided, 0);
    if constexpr (GATED) {
      const int kg = gate_idx[slot];
      if (kg >= 0)
        tile::grid_slot<TN, T>(gt, g, s, x, gate_vals + slot * bk * bn, occ,
                               kg, K, kb, bk, bn, sub_m, two_sided, 0);
    }
  }
  if constexpr (GATED)
    tile::flush<TN, T, true>(h, gt, g.t, s, out, nullptr, n, nb, bn, sub_m,
                             act, 0);
  else
    tile::flush<TN, T>(h, g.t, s, out, nullptr, n, nb, bn, sub_m, act, 0);
}

template <int TN, typename T>
void launch_tn(const T* x, const T* in_vals, const int* in_idx,
               const T* gate_vals, const int* gate_idx, const int* occ,
               T* out, int K, int nb, int mb, int max_nz, int bk, int bn,
               int bm_rows, int sub_m, int two_sided, int act,
               cudaStream_t st) {
  const dim3 grid(nb * mb, (bm_rows + tile::RS - 1) / tile::RS);
  if (act == tile::ACT_SWIGLU || act == tile::ACT_GEGLU)
    fused_ffn_kernel<TN, T, true><<<grid, tile::THREADS, 0, st>>>(
        x, in_vals, in_idx, gate_vals, gate_idx, occ, out, K, nb, mb, max_nz,
        bk, bn, bm_rows, sub_m, two_sided, act);
  else
    fused_ffn_kernel<TN, T, false><<<grid, tile::THREADS, 0, st>>>(
        x, in_vals, in_idx, gate_vals, gate_idx, occ, out, K, nb, mb, max_nz,
        bk, bn, bm_rows, sub_m, two_sided, act);
}

template <typename T>
int launch(const void* x, const void* in_vals, const int* in_idx,
           const void* gate_vals, const int* gate_idx, const int* occ,
           void* out, int K, int nb, int mb, int max_nz, int bk, int bn,
           int bm_rows, int sub_m, int two_sided, int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* it = static_cast<const T*>(in_vals);
  const T* gv = static_cast<const T*>(gate_vals);
  T* ot = static_cast<T*>(out);
  if (bn <= 64)
    launch_tn<4, T>(xt, it, in_idx, gv, gate_idx, occ, ot, K, nb, mb, max_nz,
                    bk, bn, bm_rows, sub_m, two_sided, act, st);
  else
    launch_tn<8, T>(xt, it, in_idx, gv, gate_idx, occ, ot, K, nb, mb, max_nz,
                    bk, bn, bm_rows, sub_m, two_sided, act, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// act: 0 relu, 1 relu2, 2 gelu (tanh), 3 swiglu, 4 geglu; gate_vals and
// gate_idx are read only for 3 and 4. x, the vals and out are fp32
// (bf16 == 0) or bf16 (bf16 == 1).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_ffn_spmm(const void* x, const void* in_vals,
                              const int* in_idx, const void* gate_vals,
                              const int* gate_idx, const int* occ, void* out,
                              int M, int K, int nb, int mb, int max_nz,
                              int bk, int bn, int bm_rows, int sub_m,
                              int two_sided, int act, int bf16,
                              void* stream) {
  (void)M;
  if (act < tile::ACT_RELU || act > tile::ACT_GEGLU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, in_vals, in_idx, gate_vals, gate_idx, occ,
                                 out, K, nb, mb, max_nz, bk, bn, bm_rows,
                                 sub_m, two_sided, act, st);
  return launch<float>(x, in_vals, in_idx, gate_vals, gate_idx, occ, out, K,
                       nb, mb, max_nz, bk, bn, bm_rows, sub_m, two_sided, act,
                       st);
}
