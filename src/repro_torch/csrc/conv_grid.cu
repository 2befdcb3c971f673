// Dense-grid predicated sparse conv GEMM (K2): the instrumented measurement
// path.
//
// Replaces the TPU kernel repro/kernels/sparse_conv.py:_conv_kernel
// (pallas_call in sparse_conv_spmm) together with its skip predicate
// repro/kernels/bitmask_spmm.py:subblock_macs.
//
// What it computes. patches [M, K] @ W [K, N] with W chunk-block-sparse
// (indices [nb, max_nz], -1 padded; vals [nb, max_nz, bk, bn]), fp32. For
// every (n, m) tile it visits all max_nz slots j; a slot with k =
// indices[n, j] >= 0 MACs x[m-block, k-chunk] @ vals[n, j] into the tile,
// except that, when two-sided, each sub_m-row sub-block whose activation
// occupancy bit occ[row / sub_m, k] is 0 (those rows of the chunk are all
// zero) is skipped. counts[n, m] is the number of executed sub-block MACs
// (whole-tile MACs, once per valid j, when one-sided). The flush applies
// ReLU when asked, writes the tile and, when asked, the sub_m-row occupancy
// of the result.
//
// Design. The one-stream dense grid of ffn_grid.cuh (K3's), in fp32, with
// the ReLU epilogue and the output occupancy: 64-thread CTAs over 32-row x
// 32-column tiles, 32-row tiles outermost. A first launch computes the
// activation occupancy of the chunks some slot stores (at VGG16 layer 1
// they are a third of the patch matrix's 462 MB) and zeroes the counts.
// Each CTA then reads the occupancy once per (sub-block, chunk) of its rows
// into a row mask per slot, and compacts its live slots (stored, and when
// two-sided occupied in some row of the CTA) into a list in shared memory;
// a CTA with no occupied row (an image's padding rows) stores ReLU(0) and
// leaves. The slot loop that follows has no block-wide vote, no global
// occupancy read and no shared atomic: a TMA ring of 2 whole-chunk stages
// feeds it, and each thread takes its rows' predicate once per entry, not
// in the k loop. MAC counts are integer atomics per CTA into [nb, mb]
// (order-free). Every element's sum order is the walker's (+0, k
// ascending, j ascending), so the output is bit for bit the walker's
// (walk.cu) on the same chunks: a row the grid predicates off would add
// fmaf(0, w, acc) == acc there.
//
// What bounds it on this card. fp32 FMA on the CUDA cores at 67 TFLOP/s:
// a live 32-row x 32-column x 64-deep entry is 131 KFLOP against 16 KB of
// copies, above the ridge of 20 FLOP/B. How many CTAs an SM holds decides
// how well the FMA latency is hidden: 32-deep stages, more stages, or the
// occupancy read off each staged chunk instead of a first launch were each
// slower at one of VGG16's layers 1 and 8 (PERF.md). The previous design
// (one 256-thread block per 64-row slice of a tile, as the walker's first
// 64-row mode) paid an occupancy read, a shared atomic and a block barrier per
// slot and a row predicate inside the FMA loop.
#include "ffn_grid.cuh"

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// occ is scratch of int32 [M / sub_m, K / bk] (the activation occupancy,
// which the kernel computes); occ_out, when emit_occ, int32 [M / sub_m, nb];
// counts, when count_macs, int32 [nb, mb]. x must be 16-byte aligned with
// rows of a multiple of 16 bytes, bk and bn multiples of 8 (bk <= 248,
// bn <= 128), and bm_rows dividing or a multiple of 32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int conv_grid_spmm(const float* x, const float* vals,
                              const int* indices, int* occ, float* out,
                              int* occ_out, int* counts, int M, int K, int nb,
                              int mb, int max_nz, int bk, int bn, int bm_rows,
                              int sub_m, int two_sided, int relu,
                              int emit_occ, int count_macs, int col_group,
                              void* stream) {
  (void)mb;
  fgrid::Args<float> a{};
  a.idx[0] = a.idx[1] = indices;
  a.occ = occ;
  a.out = out;
  a.occ_out = emit_occ ? occ_out : nullptr;
  a.counts = count_macs ? counts : nullptr;
  a.M = M, a.K = K, a.nb = nb, a.max_nz = max_nz, a.bk = bk, a.bn = bn;
  a.bm = bm_rows, a.sub_m = sub_m, a.two_sided = two_sided;
  a.act = relu ? tile::ACT_RELU : tile::ACT_NONE;
  a.groups = (bn + col_group - 1) / col_group;
  a.used_only = 1;
  const float* v[2] = {vals, vals};
  return fgrid::launch<float, false, false>(
      a, x, v, col_group, static_cast<cudaStream_t>(stream));
}
