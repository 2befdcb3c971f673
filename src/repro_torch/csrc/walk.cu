// Work-list walker: the compacted chunk-block-sparse implicit GEMM (K1).
//
// Replaces the TPU kernel repro/kernels/worklist_core.py:_walk_kernel
// (pallas_call in _worklist_spmm_pallas) in both of its modes: one weight
// stream (the conv path, and the FFN's output projection), or two weight
// streams sharing one slot axis (the gated FFN's in and gate projections),
// with every epilogue of worklist_core.activate and optional sub_m-row
// occupancy output.
//
// What it computes. The work list is pair-major: for every (n, m) pair of
// (output column block, row block) a contiguous segment of steps, each
// naming a stored weight slot j of block n and, per stream, its K-chunk
// (k for vals, k2 for vals2; -1 where that stream is dead at the slot). A
// dead pair is one step with every stream at -1. pair_ptr[p]..pair_ptr[p+1]
// is pair p's segment (p = n * mb + m). For each pair:
//     acc  = sum over steps with k  >= 0, ascending j, of x[m, k ] @ vals [n, j]
//     acc2 = sum over steps with k2 >= 0, ascending j, of x[m, k2] @ vals2[n, j]
//     out[m-block, n-block] = act(acc, acc2)
// and, when asked, occ[row / sub_m, n] = any(out rows of that sub-block != 0).
// A step can be live in one stream only (the gate's chunk occupied, the
// in-projection's not), so each stream is tested on its own.
//
// Design. One CUDA block owns one pair and a 64-row slice of its bm_rows
// rows (grid = pairs x slices), so every output element has exactly one
// owner: the accumulators live in registers and nothing is carried between
// blocks, where the TPU grid carried them in VMEM scratch from step to step.
// The block walks its own segment in schedule order (ascending j) and each
// chunk in k order with one fmaf per term, so the fp32 sum order of every
// element is fixed by the schedule alone: no atomics, deterministic output,
// and a batch of images gives bit for bit what each image gives alone.
// x, the weights and out are fp32 or bf16 (T): bf16 is widened when staged
// and rounded once at the store, the arithmetic is fp32 either way. The
// staging, the FMA core and the flush (with the activation table) are
// tile.cuh's, shared with the dense-grid kernels, so the work-list FFN
// schedule at bm_rows = sub_m = 8 gives bit for bit what the predicated
// grid (bitmask_spmm.cu, fused_ffn.cu) gives: both add the same terms in the
// same order (a sub-block the grid predicates off is a step the work list
// does not schedule) and flush through the same code.
//
// The gated instantiation holds 2 x 4 x TN fp32 accumulators a thread, as
// the fused FFN's does. At bm_rows = 8 a block has 8 live rows of its 64:
// staging and the store are guarded by the slice's row count, so that is
// correct, with 7/8 of the threads idle.
//
// The paper's §3.3 output-buffer colouring (ncolors, mb_per_img) selected
// which VMEM accumulator a row block used on the TPU, because consecutive
// grid steps there shared scratch. Here each block owns its accumulator, so
// no two row blocks ever share one and the colour cannot change the result;
// the arguments are accepted for interface parity and unused.
//
// What bounds it on this card. fp32 FMA on the CUDA cores (no tensor
// cores: TF32 would break the 1e-5 agreement with the fp32 reference), so
// the compute roof is 67 TFLOP/s. A live 128x128x128 step is 4.2 MFLOP
// against 128 KB of x and w tiles, 32 FLOP/B, above the ridge of 67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/B; at bn = 64 it sits at the ridge. For the FFN
// at decode (8-row blocks) a step is 0.26 MFLOP against a 64 KB weight tile:
// bytes bound. The walker has no sub-block skip: it MACs every row of a
// scheduled tile, zero rows included, so against the work the function
// needs (occupied sub-blocks only) it does more than the bound counts. Times
// and the share of the roof are in PERF.md; the likely limits, not yet
// profiled, are shared-memory bandwidth (per k: 4 + TN shared loads for
// 4 * TN FMAs), reloading the x slab once per 64-row slice and n-block, and
// at bm_rows = 8 the idle threads. wgmma/TMA staging is later work.
#include "tile.cuh"

namespace {

template <int TN, typename T, bool GATED>
__global__ void __launch_bounds__(tile::THREADS)
walk_kernel(const T* __restrict__ x, const T* __restrict__ vals,
            const T* __restrict__ vals2, const int* __restrict__ pair_ptr,
            const int* __restrict__ ks, const int* __restrict__ k2s,
            const int* __restrict__ js, T* __restrict__ out,
            int* __restrict__ occ_out, int K, int nb, int mb, int max_nz,
            int bk, int bn, int bm_rows, int sub_m, int act, int emit_occ) {
  __shared__ tile::Smem<TN> sm;
  const int p = blockIdx.x;
  const int n = p / mb, m = p % mb;
  const tile::Slice s = tile::slice_of(m, bm_rows);
  const bool all_rows[4] = {true, true, true, true};
  const T* xs = x + s.row_base * K;

  float acc[4][TN], acc2[4][TN];
  tile::zero(acc);
  if constexpr (GATED) tile::zero(acc2);
  for (int t = pair_ptr[p]; t < pair_ptr[p + 1]; ++t) {
    // both tests are uniform over the block: mac_chunk's barriers are safe
    const int kc = ks[t];
    if (kc >= 0)
      tile::mac_chunk<TN, false, T>(
          acc, sm, s, xs + (long)kc * bk,
          vals + ((long)n * max_nz + js[t]) * bk * bn, K, bk, bn, all_rows);
    if constexpr (GATED) {
      const int kg = k2s[t];
      if (kg >= 0)
        tile::mac_chunk<TN, false, T>(
            acc2, sm, s, xs + (long)kg * bk,
            vals2 + ((long)n * max_nz + js[t]) * bk * bn, K, bk, bn,
            all_rows);
    }
  }
  if constexpr (GATED)
    tile::flush<TN, T, true>(acc, acc2, sm, s, out, occ_out, n, nb, bn, sub_m,
                             act, emit_occ);
  else
    tile::flush<TN, T>(acc, sm, s, out, occ_out, n, nb, bn, sub_m, act,
                       emit_occ);
}

template <int TN, typename T>
void launch_tn(const T* x, const T* vals, const T* vals2, const int* pair_ptr,
               const int* ks, const int* k2s, const int* js, T* out,
               int* occ_out, int K, int nb, int mb, int max_nz, int bk,
               int bn, int bm_rows, int sub_m, int act, int emit_occ,
               cudaStream_t st) {
  const dim3 grid(nb * mb, (bm_rows + tile::RS - 1) / tile::RS);
  if (vals2 != nullptr)
    walk_kernel<TN, T, true><<<grid, tile::THREADS, 0, st>>>(
        x, vals, vals2, pair_ptr, ks, k2s, js, out, occ_out, K, nb, mb,
        max_nz, bk, bn, bm_rows, sub_m, act, emit_occ);
  else
    walk_kernel<TN, T, false><<<grid, tile::THREADS, 0, st>>>(
        x, vals, vals2, pair_ptr, ks, k2s, js, out, occ_out, K, nb, mb,
        max_nz, bk, bn, bm_rows, sub_m, act, emit_occ);
}

template <typename T>
int launch(const void* x, const void* vals, const void* vals2,
           const int* pair_ptr, const int* ks, const int* k2s, const int* js,
           void* out, int* occ_out, int K, int nb, int mb, int max_nz, int bk,
           int bn, int bm_rows, int sub_m, int act, int emit_occ,
           cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* v1 = static_cast<const T*>(vals);
  const T* v2 = static_cast<const T*>(vals2);
  T* ot = static_cast<T*>(out);
  if (bn <= 64)
    launch_tn<4, T>(xt, v1, v2, pair_ptr, ks, k2s, js, ot, occ_out, K, nb, mb,
                    max_nz, bk, bn, bm_rows, sub_m, act, emit_occ, st);
  else
    launch_tn<8, T>(xt, v1, v2, pair_ptr, ks, k2s, js, ot, occ_out, K, nb, mb,
                    max_nz, bk, bn, bm_rows, sub_m, act, emit_occ, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals2 and k2s are both given (the two-stream walk) or both null. act: -1
// none, 0 relu, 1 relu2, 2 gelu (tanh), 3 swiglu, 4 geglu. x, the vals and
// out are fp32 (bf16 == 0) or bf16 (bf16 == 1).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int walk_spmm(const void* x, const void* vals, const void* vals2,
                         const int* pair_ptr, const int* ks, const int* k2s,
                         const int* js, void* out, int* occ_out, int M, int K,
                         int nb, int mb, int max_nz, int bk, int bn,
                         int bm_rows, int sub_m, int act, int emit_occ,
                         int ncolors, int mb_per_img, int bf16,
                         void* stream) {
  (void)M;
  (void)ncolors;     // see the note on colouring above
  (void)mb_per_img;
  if ((vals2 == nullptr) != (k2s == nullptr) || act < tile::ACT_NONE ||
      act > tile::ACT_GEGLU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, vals, vals2, pair_ptr, ks, k2s, js, out,
                                 occ_out, K, nb, mb, max_nz, bk, bn, bm_rows,
                                 sub_m, act, emit_occ, st);
  return launch<float>(x, vals, vals2, pair_ptr, ks, k2s, js, out, occ_out, K,
                       nb, mb, max_nz, bk, bn, bm_rows, sub_m, act, emit_occ,
                       st);
}
