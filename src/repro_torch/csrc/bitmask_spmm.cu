// Predicated chunk-block-sparse matmul (K3): the LM FFN's output projection.
//
// Replaces the TPU kernel repro/kernels/bitmask_spmm.py:_kernel (pallas_call
// in bitmask_spmm) and its skip predicate subblock_macs (same file).
//
// What it computes. x [M, K] @ W [K, N] with W chunk-block-sparse (indices
// [nb, max_nz] of K-chunk ids, -1 padded; vals [nb, max_nz, bk, bn]). For
// each (n, m) tile it visits every slot j; a slot with k = indices[n, j] >= 0
// MACs x[m-block, k-chunk] @ vals[n, j] into an fp32 tile, except that, when
// two-sided, each sub_m-row sub-block whose occupancy bit occ[row / sub_m, k]
// is 0 is skipped. counts[n, m] (optional) is the number of executed
// sub-block MACs, or one per valid j when one-sided. The tile is written in
// the storage type of x (fp32, or bf16 rounded to nearest even).
//
// Design. This is the conv dense grid (conv_grid.cu) without its ReLU and
// occupancy epilogue, for fp32 and bf16 storage: one CUDA block per (n, m,
// 64-row slice), the j loop inside the block and the accumulator in
// registers, each slot a tile::grid_slot (the sub_m skip as a row predicate,
// with a whole-slot skip when no row of the slice is live), and per-slice
// count partials that the wrapper sums. A sub_m-row sub-block wider than a
// slice (sub_m = 128) counts once, in the slice of its first row. Every output row's fp32
// sum order is fixed by the packing alone (ascending j, then k), so a row's
// result does not depend on the other rows of its block: a decode batch
// gives bit for bit what each of its lanes gives alone.
//
// What bounds it on this card. At decode (a few live rows in a 128-row
// block) the work is the stored weight tiles, so the bound is bytes: each
// stored tile is read from HBM once per live slice. At prefill (128 rows) it
// is fp32 FMA on the CUDA cores at 67 TFLOP/s. Both sit far from the kernel's
// time (PERF.md): the grid at Qwen3-4B's out-projection is only nb = 20
// n-blocks x 2 slices for 132 SMs, each walking max_nz = 76 chunks in turn,
// and bf16 tiles are widened element by element while staging. Splitting the
// j loop across blocks, wgmma on bf16 tiles and TMA staging are later work.
#include "tile.cuh"

namespace {

template <int TN, typename T>
__global__ void __launch_bounds__(tile::THREADS)
bitmask_spmm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                    const int* __restrict__ indices,
                    const int* __restrict__ occ, T* __restrict__ out,
                    int* __restrict__ counts, int K, int nb, int mb,
                    int max_nz, int bk, int bn, int bm_rows, int sub_m,
                    int two_sided, int count_macs) {
  __shared__ tile::GridSmem<TN> g;
  const int p = blockIdx.x;
  const int n = p / mb, m = p % mb;
  const tile::Slice s = tile::slice_of(m, bm_rows);
  const int kb = K / bk;

  if (s.tid == 0) g.cnt = 0;
  __syncthreads();

  float acc[4][TN];
  tile::zero(acc);
  for (int j = 0; j < max_nz; ++j) {
    const int kc = indices[n * max_nz + j];
    if (kc < 0) continue;  // padding slot: no MAC, no count
    tile::grid_slot<TN, T>(acc, g, s, x,
                           vals + ((long)n * max_nz + j) * bk * bn, occ, kc,
                           K, kb, bk, bn, sub_m, two_sided, count_macs);
  }
  tile::flush<TN, T>(acc, g.t, s, out, nullptr, n, nb, bn, sub_m,
                     tile::ACT_NONE, 0);
  __syncthreads();
  if (count_macs && s.tid == 0)
    counts[(long)p * gridDim.y + blockIdx.y] = g.cnt;
}

template <typename T>
int launch(const void* x, const void* vals, const int* indices,
           const int* occ, void* out, int* counts, int K, int nb, int mb,
           int max_nz, int bk, int bn, int bm_rows, int sub_m, int two_sided,
           int count_macs, cudaStream_t st) {
  const dim3 grid(nb * mb, (bm_rows + tile::RS - 1) / tile::RS);
  const T* xt = static_cast<const T*>(x);
  const T* vt = static_cast<const T*>(vals);
  T* ot = static_cast<T*>(out);
  if (bn <= 64)
    bitmask_spmm_kernel<4, T><<<grid, tile::THREADS, 0, st>>>(
        xt, vt, indices, occ, ot, counts, K, nb, mb, max_nz, bk, bn, bm_rows,
        sub_m, two_sided, count_macs);
  else
    bitmask_spmm_kernel<8, T><<<grid, tile::THREADS, 0, st>>>(
        xt, vt, indices, occ, ot, counts, K, nb, mb, max_nz, bk, bn, bm_rows,
        sub_m, two_sided, count_macs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, vals and out are fp32 (bf16 == 0) or bf16 (bf16 == 1). counts, when
// count_macs, is int32 [nb * mb, slices] of per-slice partials (slices =
// ceil(bm_rows / 64)); the wrapper sums the last axis.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bitmask_spmm(const void* x, const void* vals,
                            const int* indices, const int* occ, void* out,
                            int* counts, int M, int K, int nb, int mb,
                            int max_nz, int bk, int bn, int bm_rows,
                            int sub_m, int two_sided, int count_macs,
                            int bf16, void* stream) {
  (void)M;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, vals, indices, occ, out, counts, K, nb,
                                 mb, max_nz, bk, bn, bm_rows, sub_m,
                                 two_sided, count_macs, st);
  return launch<float>(x, vals, indices, occ, out, counts, K, nb, mb, max_nz,
                       bk, bn, bm_rows, sub_m, two_sided, count_macs, st);
}
