// Dense-grid predicated sparse conv GEMM: the instrumented measurement path.
//
// Replaces the TPU kernel repro/kernels/sparse_conv.py:_conv_kernel
// (pallas_call in sparse_conv_spmm) together with its skip predicate
// repro/kernels/bitmask_spmm.py:subblock_macs.
//
// What it computes. patches [M, K] @ W [K, N] with W chunk-block-sparse
// (indices [nb, max_nz], -1 padded; vals [nb, max_nz, bk, bn]). For every
// (n, m) tile it visits all max_nz slots j; a slot with k = indices[n, j] >= 0
// MACs x[m-block, k-chunk] @ vals[n, j] into the tile, except that, when
// two-sided, each sub_m-row sub-block whose activation occupancy bit
// occ[row / sub_m, k] is 0 (those rows of the chunk are all zero) is skipped.
// counts[n, m] is the number of executed sub-block MACs (whole-tile MACs,
// once per valid j, when one-sided). The flush applies ReLU when asked,
// writes the tile and, when asked, the sub_m-row occupancy of the result.
//
// Design. One CUDA block per (n, m, 64-row slice); the j loop that was the
// TPU's sequential grid axis runs inside the block, accumulating in
// registers, so nothing is carried between blocks. The skip is a row
// predicate on the FMA code (no tensor cores, so no 16-row tile limit): per
// j the block stages one live flag per row in shared memory, skips the whole
// slot when no row of its slice is live (__syncthreads_or), and otherwise
// predicates each thread's rows. Sub-blocks never straddle a slice (sub_m
// divides 64), so each slice counts the live sub-blocks that start in it
// into a shared integer, and the wrapper sums the per-slice partials: the
// total equals the TPU kernel's per-tile count exactly. One-sided counts
// come from slice 0 only, so a tile counts once per valid j. The staging,
// the FMA core (with the row predicate) and the flush are tile.cuh's, shared
// with the walker (walk.cu), so the two sum in the same order.
//
// What bounds it on this card. fp32 FMA on the CUDA cores at 67 TFLOP/s;
// compared with the walker it also pays an indices and occupancy read per
// slot and a block barrier per j. Like the walker it stays well below both
// roofs (times in PERF.md); shared-memory bandwidth and x-slab reloads are
// the likely limits, not yet profiled. This path measures skips and checks
// the skip model; the walker is the serving path.
#include "tile.cuh"

namespace {

template <int TN>
__global__ void __launch_bounds__(tile::THREADS)
conv_grid_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                 const int* __restrict__ indices, const int* __restrict__ occ,
                 float* __restrict__ out, int* __restrict__ occ_out,
                 int* __restrict__ counts, int K, int nb, int mb, int max_nz,
                 int bk, int bn, int bm_rows, int sub_m, int two_sided,
                 int relu, int emit_occ, int count_macs) {
  __shared__ tile::Smem<TN> sm;
  __shared__ int live_row[tile::RS];
  __shared__ int cnt;
  const int p = blockIdx.x;
  const int n = p / mb, m = p % mb;
  const tile::Slice s = tile::slice_of(m, bm_rows);
  const int kb = K / bk;

  if (s.tid == 0) cnt = 0;
  __syncthreads();

  float acc[4][TN];
  tile::zero(acc);
  for (int j = 0; j < max_nz; ++j) {
    const int kc = indices[n * max_nz + j];
    if (kc < 0) continue;  // padding slot: no MAC, no count
    // live_row is safe to rewrite here: the previous slot's readers copied
    // it to registers before the k-slab barriers of mac_chunk
    int live = 0;
    if (s.tid < tile::RS) {
      if (s.tid < s.rows)
        live = two_sided
                   ? occ[((s.row_base + s.tid) / sub_m) * kb + kc] != 0
                   : 1;
      live_row[s.tid] = live;
      if (count_macs && live) {
        if (two_sided) {
          if (s.tid % sub_m == 0) atomicAdd(&cnt, 1);
        } else if (s.tid == 0 && blockIdx.y == 0) {
          atomicAdd(&cnt, 1);
        }
      }
    }
    // no live row in this slice: skip the whole slot
    if (!__syncthreads_or(live)) continue;
    bool lv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = live_row[s.ty * 4 + i] != 0;
    tile::mac_chunk<TN, true>(acc, sm, s, x + s.row_base * K + (long)kc * bk,
                              vals + ((long)n * max_nz + j) * bk * bn, K, bk,
                              bn, lv);
  }
  tile::flush(acc, sm, s, out, occ_out, n, nb, bn, sub_m, relu, emit_occ);
  __syncthreads();
  if (count_macs && s.tid == 0)
    counts[(long)p * gridDim.y + blockIdx.y] = cnt;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts, when count_macs, is int32 [nb * mb, slices] of per-slice partials
// (slices = ceil(bm_rows / 64)); the wrapper sums the last axis.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int conv_grid_spmm(const float* x, const float* vals,
                              const int* indices, const int* occ, float* out,
                              int* occ_out, int* counts, int M, int K, int nb,
                              int mb, int max_nz, int bk, int bn, int bm_rows,
                              int sub_m, int two_sided, int relu,
                              int emit_occ, int count_macs, void* stream) {
  (void)M;
  const dim3 grid(nb * mb, (bm_rows + tile::RS - 1) / tile::RS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn <= 64)
    conv_grid_kernel<4><<<grid, tile::THREADS, 0, st>>>(
        x, vals, indices, occ, out, occ_out, counts, K, nb, mb, max_nz, bk, bn,
        bm_rows, sub_m, two_sided, relu, emit_occ, count_macs);
  else
    conv_grid_kernel<8><<<grid, tile::THREADS, 0, st>>>(
        x, vals, indices, occ, out, occ_out, counts, K, nb, mb, max_nz, bk, bn,
        bm_rows, sub_m, two_sided, relu, emit_occ, count_macs);
  return static_cast<int>(cudaGetLastError());
}
