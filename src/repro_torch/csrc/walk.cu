// Work-list walker: the compacted chunk-block-sparse implicit GEMM.
//
// Replaces the TPU kernel repro/kernels/worklist_core.py:_walk_kernel
// (pallas_call in _worklist_spmm_pallas), single weight stream, epilogue
// none or ReLU, optional sub_m-row occupancy output.
//
// What it computes. The work list is pair-major: for every (n, m) pair of
// (output column block, row block) a contiguous segment of steps, each
// naming a stored weight chunk j of block n and its K-chunk k. A dead pair
// is one step with k == -1. pair_ptr[p]..pair_ptr[p+1] is pair p's segment
// (p = n * mb + m). For each pair:
//     out[m-block, n-block] = act( sum over live steps, ascending j, of
//                                  x[m-block, k-chunk] @ vals[n, j] )
// and, when asked, occ[row / sub_m, n] = any(out rows of that sub-block != 0).
//
// Design. One CUDA block owns one pair and a 64-row slice of its bm_rows
// rows (grid = pairs x slices), so every output element has exactly one
// owner: the accumulator lives in registers and nothing is carried between
// blocks, where the TPU grid carried it in VMEM scratch from step to step.
// The block walks its own segment in schedule order (ascending j) and each
// chunk in k order with one fmaf per term, so the fp32 sum order of every
// element is fixed by the schedule alone: no atomics, deterministic output,
// and a batch of images gives bit for bit what each image gives alone.
// The staging, the FMA core and the flush are tile.cuh's, shared with the
// dense grid (conv_grid.cu).
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
// over 3.35 TB/s = 20 FLOP/B; at bn = 64 it sits at the ridge. The walker
// has no sub-block skip: it MACs every row of a scheduled tile, zero rows
// included, so against the work the function needs (occupied sub-blocks
// only) it does more than the bound counts. Times and the share of the roof
// are in PERF.md; the likely limits, not yet profiled, are shared-memory
// bandwidth (per k: 4 + TN shared loads for 4 * TN FMAs) and reloading the
// x slab once per 64-row slice and n-block. wgmma/TMA staging is later work.
#include "tile.cuh"

namespace {

template <int TN>
__global__ void __launch_bounds__(tile::THREADS)
walk_kernel(const float* __restrict__ x, const float* __restrict__ vals,
            const int* __restrict__ pair_ptr, const int* __restrict__ ks,
            const int* __restrict__ js, float* __restrict__ out,
            int* __restrict__ occ_out, int K, int nb, int mb, int max_nz,
            int bk, int bn, int bm_rows, int sub_m, int relu, int emit_occ) {
  __shared__ tile::Smem<TN> sm;
  const int p = blockIdx.x;
  const int n = p / mb, m = p % mb;
  const tile::Slice s = tile::slice_of(m, bm_rows);
  const bool all_rows[4] = {true, true, true, true};

  float acc[4][TN];
  tile::zero(acc);
  for (int t = pair_ptr[p]; t < pair_ptr[p + 1]; ++t) {
    const int kc = ks[t];
    if (kc < 0) continue;  // flush-only step of a dead pair
    tile::mac_chunk<TN, false>(
        acc, sm, s, x + s.row_base * K + (long)kc * bk,
        vals + ((long)n * max_nz + js[t]) * bk * bn, K, bk, bn, all_rows);
  }
  tile::flush(acc, sm, s, out, occ_out, n, nb, bn, sub_m, relu, emit_occ);
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int walk_spmm(const float* x, const float* vals,
                         const int* pair_ptr, const int* ks, const int* js,
                         float* out, int* occ_out, int M, int K, int nb,
                         int mb, int max_nz, int bk, int bn, int bm_rows,
                         int sub_m, int relu, int emit_occ, int ncolors,
                         int mb_per_img, void* stream) {
  (void)M;
  (void)ncolors;     // see the note on colouring above
  (void)mb_per_img;
  const dim3 grid(nb * mb, (bm_rows + tile::RS - 1) / tile::RS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn <= 64)
    walk_kernel<4><<<grid, tile::THREADS, 0, st>>>(
        x, vals, pair_ptr, ks, js, out, occ_out, K, nb, mb, max_nz, bk, bn,
        bm_rows, sub_m, relu, emit_occ);
  else
    walk_kernel<8><<<grid, tile::THREADS, 0, st>>>(
        x, vals, pair_ptr, ks, js, out, occ_out, K, nb, mb, max_nz, bk, bn,
        bm_rows, sub_m, relu, emit_occ);
  return static_cast<int>(cudaGetLastError());
}
