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
// Design. The one-stream grid of ffn_grid.cuh: one 64-thread CTA per
// 32-row x 16- or 32-column tile of an n-block, its live slots compacted
// first, their x rows and weight columns streamed through a TMA ring, and
// MAC counts added per CTA (integer atomics on counts, none on the output).
// Row blocks bm_rows divide 32 or are multiples of 32, and the last 32-row
// tile may be partial (M = 8, say); any other bm_rows (48) is refused.
// Every output element's fp32 sum order is fixed by the packing alone
// (ascending j, then k), so a row's result does not depend on the other
// rows of its block: a decode batch gives bit for bit what each lane gives
// alone.
//
// What bounds it on this card. At decode (4 live rows of a 128-row block)
// the work is the stored weight tiles, each read once: bytes, 0.015 ms for
// Qwen3-4B's bf16 out-projection at 3.35 TB/s. But every output element is
// one chain of max_nz * bk dependent fmaf (9728 there) that no split may
// reorder, so the kernel runs on the latency of 160 busy CTAs' threads (16
// columns each of 20 n-blocks), each walking 76 entries; the one-tile
// layout gives each thread 2 chains fed from fp32 copies in shared memory.
// At a 128-row prefill the bound is fp32 FMA at 67 TFLOP/s. Tensor cores
// (wgmma on bf16 tiles) would change the sum order that the compact
// schedule matches bit for bit, so they wait for a mode that K1, K3 and K4
// share.
#include "ffn_grid.cuh"

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T>
static int run(const void* x, const void* vals, const int* indices,
               int* occ, void* out, int* counts, int M, int K, int nb,
               int max_nz, int bk, int bn, int bm_rows, int sub_m,
               int two_sided, int col_group, cudaStream_t st) {
  fgrid::Args<T> a{};
  a.idx[0] = a.idx[1] = indices;
  a.occ = occ;
  a.out = static_cast<T*>(out);
  a.counts = counts;
  a.M = M, a.K = K, a.nb = nb, a.max_nz = max_nz, a.bk = bk, a.bn = bn;
  a.bm = bm_rows, a.sub_m = sub_m, a.two_sided = two_sided;
  a.act = tile::ACT_NONE;
  a.groups = (bn + col_group - 1) / col_group;
  const T* v[2] = {static_cast<const T*>(vals), static_cast<const T*>(vals)};
  return fgrid::launch<T, false, false>(a, static_cast<const T*>(x), v,
                                        col_group, st);
}

// x, vals and out are fp32 (bf16 == 0) or bf16 (bf16 == 1). counts, when
// count_macs, is int32 [nb, mb] (mb = M / bm_rows), zeroed by the
// occupancy launch and added to by every CTA of column group 0.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int bitmask_spmm(const void* x, const void* vals,
                            const int* indices, int* occ, void* out,
                            int* counts, int M, int K, int nb, int mb,
                            int max_nz, int bk, int bn, int bm_rows,
                            int sub_m, int two_sided, int count_macs,
                            int bf16, int col_group, void* stream) {
  (void)mb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = count_macs ? counts : nullptr;
  if (bf16)
    return run<__nv_bfloat16>(x, vals, indices, occ, out, cnt, M, K, nb,
                              max_nz, bk, bn, bm_rows, sub_m, two_sided,
                              col_group, st);
  return run<float>(x, vals, indices, occ, out, cnt, M, K, nb, max_nz, bk,
                    bn, bm_rows, sub_m, two_sided, col_group, st);
}
