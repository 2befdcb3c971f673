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
// Two modes, chosen by the wrapper (worklist_spmm in
// repro_torch/kernels/worklist_core.py) from the row block bm_rows.
//
// The 64-row mode (bm_rows not dividing 32, the conv path's 128-row
// blocks; or a tile the grid's copies cannot take). One CUDA block owns one
// pair and a 64-row slice of its bm_rows rows (grid = pairs x slices), so
// every output element has exactly one owner: the accumulators live in
// registers and nothing is carried between blocks, where the TPU grid
// carried them in VMEM scratch from step to step. The block walks its own
// segment in schedule order (ascending j) and each chunk in k order with one
// fmaf per term. The staging, the FMA core and the flush (with the
// activation table) are tile.cuh's.
//
// The grid mode (bm_rows dividing 32: the compact FFN schedule's 8-row
// blocks, also 16 and 32). A 64-row block for one 8-row pair held 7/8 of
// its threads idle, gave a decode step one block per n-block (76 for
// Qwen3-4B's in/gate projection on 132 SMs), and re-staged a weight tile
// once per pair at a prefill. This mode runs on the grid of the dense FFN
// kernels (ffn_grid.cuh): 64-thread CTAs over 32-row x 16- or 32-column
// tiles of an n-block, busy CTAs first in the launch, a TMA ring, two thread
// layouts, and for two streams CTA pairs in a cluster whose gate CTA hands
// its accumulators to the in CTA over distributed shared memory. A CTA
// merges the work-list segments of the 32 / bm_rows pairs its rows cover
// into one live list in ascending j, each entry with its rows per stream,
// so a weight tile is staged once for all of them and a decode step gets
// a CTA per column group of every n-block (608 busy CTAs for that in/gate
// projection). Dead pairs flush act(0) like every other row.
//
// Sum order, either mode. Every element is one fp32 chain per stream: +0,
// then k ascending within a chunk and j ascending across steps, one fmaf
// per term. So the fp32 sum order of every element is fixed by the
// schedule alone: no atomics on the output, deterministic output, and a
// batch of images gives bit for bit what each image gives alone. x, the
// weights and out are fp32 or bf16 (T): bf16 is widened when staged and
// rounded once at the store, the arithmetic is fp32 either way. The
// work-list FFN schedule at bm_rows = sub_m = 8 gives bit for bit what the
// predicated grid (bitmask_spmm.cu, fused_ffn.cu) gives: both add the same
// terms in the same order (a sub-block the grid predicates off is a step
// the work list does not schedule), on the same grid, and flush through
// the same code.
//
// The paper's §3.3 output-buffer colouring (ncolors, mb_per_img) selected
// which VMEM accumulator a row block used on the TPU, because consecutive
// grid steps there shared scratch. Here each block owns its accumulator, so
// no two row blocks ever share one and the colour cannot change the result;
// the arguments are accepted for interface parity and unused.
//
// What bounds it on this card. fp32 FMA on the CUDA cores (no tensor
// cores: TF32 or bf16 products summed in another order would break the
// bitwise invariants and the 1e-5 agreement with the fp32 reference), so
// the compute roof is 67 TFLOP/s. A live 128x128x128 step is 4.2 MFLOP
// against 128 KB of x and w tiles, 32 FLOP/B, above the ridge of 67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/B: the conv path is bound by operations. At
// decode an 8-row step is 0.26 MFLOP against a 64 KB weight tile, below the
// ridge, but each element's chain of dependent fmaf runs on the latency of
// a few busy CTAs per SM, as in the dense FFN kernels (PERF.md).
#include "ffn_grid.cuh"

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
  const T* xs = x + s.row_base * K;

  float acc[4][TN], acc2[4][TN];
  tile::zero(acc);
  if constexpr (GATED) tile::zero(acc2);
  for (int t = pair_ptr[p]; t < pair_ptr[p + 1]; ++t) {
    // both tests are uniform over the block: mac_chunk's barriers are safe
    const int kc = ks[t];
    if (kc >= 0)
      tile::mac_chunk<TN, T>(acc, sm, s, xs + (long)kc * bk,
                             vals + ((long)n * max_nz + js[t]) * bk * bn, K,
                             bk, bn);
    if constexpr (GATED) {
      const int kg = k2s[t];
      if (kg >= 0)
        tile::mac_chunk<TN, T>(acc2, sm, s, xs + (long)kg * bk,
                               vals2 + ((long)n * max_nz + js[t]) * bk * bn,
                               K, bk, bn);
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

// The grid mode: the work list's segments merged per 32-row CTA
// (ffn_grid.cuh), whole chunks per ring stage.
template <typename T>
int launch_grid(const void* x, const void* vals, const void* vals2,
                const int* pair_ptr, const int* ks, const int* k2s,
                const int* js, void* out, int* occ_out, int M, int K, int nb,
                int max_nz, int bk, int bn, int bm_rows, int sub_m, int act,
                int emit_occ, int col_group, cudaStream_t st) {
  fgrid::Args<T> a{};
  a.pair_ptr = pair_ptr;
  a.ks[0] = ks, a.ks[1] = k2s;
  a.js = js;
  a.out = static_cast<T*>(out);
  a.occ_out = emit_occ ? occ_out : nullptr;
  a.M = M, a.K = K, a.nb = nb, a.max_nz = max_nz, a.bk = bk, a.bn = bn;
  a.bm = bm_rows, a.sub_m = sub_m, a.act = act;
  a.groups = (bn + col_group - 1) / col_group;
  const T* v[2] = {static_cast<const T*>(vals),
                   static_cast<const T*>(vals2 ? vals2 : vals)};
  const T* xt = static_cast<const T*>(x);
  if (vals2 != nullptr)
    return fgrid::launch<T, true, true>(a, xt, v, col_group, st);
  return fgrid::launch<T, false, true>(a, xt, v, col_group, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals2 and k2s are both given (the two-stream walk) or both null. act: -1
// none, 0 relu, 1 relu2, 2 gelu (tanh), 3 swiglu, 4 geglu. x, the vals and
// out are fp32 (bf16 == 0) or bf16 (bf16 == 1). col_group 16 or 32 runs the
// grid mode (bm_rows dividing 32), 0 the 64-row mode.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int walk_spmm(const void* x, const void* vals, const void* vals2,
                         const int* pair_ptr, const int* ks, const int* k2s,
                         const int* js, void* out, int* occ_out, int M, int K,
                         int nb, int mb, int max_nz, int bk, int bn,
                         int bm_rows, int sub_m, int act, int emit_occ,
                         int ncolors, int mb_per_img, int bf16,
                         int col_group, void* stream) {
  (void)ncolors;     // see the note on colouring above
  (void)mb_per_img;
  if ((vals2 == nullptr) != (k2s == nullptr) || act < tile::ACT_NONE ||
      act > tile::ACT_GEGLU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (col_group != 0) {
    if (bf16)
      return launch_grid<__nv_bfloat16>(x, vals, vals2, pair_ptr, ks, k2s, js,
                                        out, occ_out, M, K, nb, max_nz, bk,
                                        bn, bm_rows, sub_m, act, emit_occ,
                                        col_group, st);
    return launch_grid<float>(x, vals, vals2, pair_ptr, ks, k2s, js, out,
                              occ_out, M, K, nb, max_nz, bk, bn, bm_rows,
                              sub_m, act, emit_occ, col_group, st);
  }
  if (bf16)
    return launch<__nv_bfloat16>(x, vals, vals2, pair_ptr, ks, k2s, js, out,
                                 occ_out, K, nb, mb, max_nz, bk, bn, bm_rows,
                                 sub_m, act, emit_occ, st);
  return launch<float>(x, vals, vals2, pair_ptr, ks, k2s, js, out, occ_out, K,
                       nb, mb, max_nz, bk, bn, bm_rows, sub_m, act, emit_occ,
                       st);
}
