// The grid body shared by the dense-grid conv (K2, conv_grid.cu), the
// predicated sparse matmul (K3, bitmask_spmm.cu), the fused FFN (K4,
// fused_ffn.cu) and the walker's grid mode (K1 at bm_rows dividing 32,
// walk.cu), laid out for the H100's SMs and its tensor memory accelerator
// (TMA). The TPU kernels these replace are named in each .cu.
//
// Geometry. One CTA of 64 threads owns a 32-row x CG-column tile of one
// n-block's output for one weight stream (CG = 16 or 32, chosen by the
// wrapper: grid_geometry in repro_torch/kernels/grid.py). CTAs are numbered
// (row_tile * nb + n) * groups + cg, 32-row tiles outermost: a decode step's
// live rows lie in the first 32 rows of a row block, so its busy CTAs come
// first in the launch and spread over every SM (with the row tiles of one
// column group adjacent they fell at a fixed stride and crowded onto a
// quarter of the SMs). The last 32-row tile may be partial: its rows past M
// take no term and are neither stored nor counted; TMA fills the x rows
// past M of a box with zeros, and a box wholly past M is not copied. A row
// block bm may divide 32 (a CTA covers several) or be a multiple of 32
// (several CTAs cover it); bm = 48, say, is refused. Two weight streams run
// as CTA pairs (clusters of 2): rank 0 the first (in) stream, rank 1 the
// second (gate), so the two chains of every element run in parallel, and
// rank 1 hands its accumulators to rank 0 through distributed shared memory
// for the flush.
//
// Slots. Each CTA first builds, in shared memory, one {chunk, row mask}
// per weight slot j of its n-block and stream: the rows of the CTA that add
// that slot's term. Two sources:
// - the dense grid (K2, K3, K4): a slot's chunk is idx[n, j] (-1: nothing)
//   and, when two-sided, its rows are those whose sub_m sub-block is
//   occupied in that chunk, from occ, which a first launch (occ_kernel)
//   computes with one warp per sub-block and chunk (it also zeroes the MAC
//   counts; for the conv it reads only the chunks some slot stores). A CTA
//   whose rows are all zero (a decode step's padding, an image's padding
//   rows) stores act(0) and leaves after one round of occupancy loads: at
//   Qwen3-4B's decode three CTAs in four are such;
// - the work list (K1): a CTA reads the segments of the 32 / bm_rows pairs
//   (n, m) its rows cover, and every step whose chunk is live in the CTA's
//   stream sets that slot's chunk and ORs the pair's bm_rows rows into its
//   mask (a max_nz-long table, scanned once). build_worklist schedules a
//   pair's slots in ascending j and names the same chunk for a slot in
//   every pair, so the merge keeps each pair's order and the result is the
//   schedule the walker reports (walk_lists in grid.py models it). A CTA
//   none of whose pairs has a live step in either stream stores act(0) and
//   leaves.
// Warp 0 then compacts the slots with a row into the CTA's live list, in
// ascending j; a dead row takes no term.
//
// Ring. Thread 0 copies each entry's x rows (8-row boxes) and [bk, CG]
// weight columns into a stage of a shared-memory ring with TMA tensor
// copies that complete on the stage's mbarrier, ahead of the entry being
// multiplied and across slot boundaries: one instruction per box, where
// 16-byte cp.async copies cost a thread instruction and a tracked request
// per 16 bytes. The x box is 8 elements wider than the chunk: rows land
// 16 (bf16) or 32 (fp32) bytes off bank alignment, and the extra columns
// (zeros past K) are never used.
//
// Two thread layouts, chosen per CTA from the union of both streams' row
// masks (so the two CTAs of a pair lay out their threads alike). When
// every live row lies in one 8-row tile (a decode step: up to 8 lanes in a
// sub_m = 8 sub-block), only those 8 x rows are copied, the CTA widens them
// once per entry into an fp32 copy laid out k-major (and, at 16 columns,
// the bf16 weight columns into an fp32 copy), and each thread owns CG / 16
// rows x 2 columns; the ring then holds 3 entries. Otherwise (a prefill, a
// conv tile) each thread owns 4 rows (rg + 8 i) x CG / 8 adjacent columns,
// widening bf16 as it reads, and the ring holds 2 entries: more stages cost
// CTAs per SM, and at VGG16's shapes as at the LMs' the CTAs an SM holds
// matter more than the copies in flight. The row predicate is taken once
// per entry, not in the k loop. Inside an entry each thread loads the next
// k-group's operands while it multiplies the current one.
//
// Sum order. Every output element is one fp32 chain per stream: +0, then
// acc = fmaf(x, w, acc) for k ascending within a chunk and j ascending
// across entries: the order of the walker's tile mode (walk.cu), so that
// mode and this grid give bit for bit the same output on the same terms (a
// row predicated off here adds fmaf(0, w, acc) == acc there), and the
// compact FFN schedule (K1 here) gives bit for bit what the dense one (K4,
// K3) gives. The flush computes what the tile mode's flush computes (None
// and ReLU inline, every other act through the out-of-line tile::activate,
// one rounding at the store). No atomics touch the output, and nothing is
// carried between tiles: a row's result does not depend on the other rows
// of its block.
//
// Counts. With counts each CTA of column group 0 adds (integer atomics,
// order-free) to counts[n, m], for each row block m starting in its rows:
// the live sub-blocks whose first row it holds (two-sided), or one per
// stored slot (one-sided). With occ_out, each CTA ORs 1 into
// occ_out[row / sub_m, n] for every row it stored a non-zero to (after a
// memset of occ_out).
//
// What bounds it on this card. fp32 FMA on the CUDA cores (67 TFLOP/s;
// tensor cores would change the sum order that the bitwise invariants
// fix), or at decode the latency of each element's one chain of dependent
// fmaf, fed from shared memory by a few busy CTAs per SM; HBM bytes are far
// below either (PERF.md).
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace fgrid {

constexpr int ROWS = 32;      // rows of a block (ROW_BLOCK in Python)
constexpr int TILE = 8;       // rows of an x box and of the one-tile layout
constexpr int NT = 64;        // threads of a block
constexpr int PAD = 8;        // extra x columns of a box, and weight rows
                              // after each stage's columns: room for the
                              // register prefetch's overrun
constexpr int MAX_STAGES = 6;  // mbarriers a CTA keeps

template <typename T>
struct Args {
  const int* idx[2];        // dense grid: per stream [nb, max_nz], -1 padded
  const int* pair_ptr;      // work list: [nb * mb + 1] segment offsets
  const int* ks[2];         // work list: per stream the chunk of each step
  const int* js;            // work list: the slot of each step
  int* occ;                 // dense grid: [M / sub_m, K / bk], occ_kernel's
  T* out;                   // [M, nb * bn]
  int* occ_out;             // [M / sub_m, nb] output occupancy, or null
  int* counts;              // [nb, M / bm], or null
  int M, K, nb, max_nz, bk, bn, bm, sub_m, two_sided, act, groups;
  int used_only;            // occ_kernel reads only chunks idx[0] stores
                            // (the conv's, a third of the columns at
                            // VGG16 layer 1; the LM's use them all)
};

// bf16 bits to fp32: exact, as __bfloat162float
__device__ inline float lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ inline float hi(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// N consecutive staged elements, loaded raw and widened to fp32 when used.
template <typename T, int N>
struct Vec;
template <>
struct Vec<float, 4> {
  using R = float4;
  static __device__ void widen(R r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
};
template <>
struct Vec<float, 2> {
  using R = float2;
  static __device__ void widen(R r, float (&v)[2]) { v[0] = r.x, v[1] = r.y; }
};
template <>
struct Vec<float, 1> {
  using R = float;
  static __device__ void widen(R r, float (&v)[1]) { v[0] = r; }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  using R = uint2;
  static __device__ void widen(R r, float (&v)[4]) {
    v[0] = lo(r.x), v[1] = hi(r.x), v[2] = lo(r.y), v[3] = hi(r.y);
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using R = unsigned;
  static __device__ void widen(R r, float (&v)[2]) {
    v[0] = lo(r), v[1] = hi(r);
  }
};
template <typename T, int N>
__device__ inline typename Vec<T, N>::R ldv(const T* p) {
  return *reinterpret_cast<const typename Vec<T, N>::R*>(p);
}

// whether v is non-zero once stored as T
__device__ inline bool stored_nonzero(float v, const float*) {
  return v != 0.f;
}
__device__ inline bool stored_nonzero(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v)) != 0.f;
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ inline void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ inline void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ inline void tma2(void* dst, const CUtensorMap* map, int c0, int c1,
                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ inline void tma3(void* dst, const CUtensorMap* map, int c0, int c1,
                            int c2, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Elements of one stage holding nx x rows: x [nx, bk + PAD], then the
// weight columns [bk (+ PAD unused), CG]. A multiple of 128 bytes, as TMA
// destinations need, since bk is a multiple of 8.
template <int CG>
__host__ __device__ inline int stage_elems(int bk, int nx) {
  return nx * (bk + PAD) + (bk + PAD) * CG;
}

// Whether the one-tile layout widens bf16 weight columns into an fp32 copy
// once per entry (16-column blocks), or every thread widens its own pairs
// as it reads them (32-column blocks, where the fp32 copy would cost each
// SM a CTA of the decode grid).
template <typename T, int CG>
__host__ __device__ constexpr bool wide_w() {
  return sizeof(T) == 2 && CG == 16;
}

// fp32 operands of the one-tile layout, rebuilt for every entry: x k-major
// [bk + PAD][8] and, with wide_w, the weight columns [bk + PAD][CG].
template <typename T, int CG>
__host__ __device__ inline int tile_floats(int bk) {
  return (bk + PAD) * (TILE + (wide_w<T, CG>() ? CG : 0));
}

// Elements of the shared region: the ring of the 32-row layout, or the
// one-tile layout's fp32 operands and its ring of smaller stages,
// whichever is larger. 2 stages of the 32-row layout and 3 of the 8-row
// one, so that at Qwen3-4B's shapes five bf16 CTAs fit an SM.
template <typename T, int CG>
__host__ __device__ inline int region_elems(int bk) {
  const int wide = 2 * stage_elems<CG>(bk, ROWS);
  const int one = tile_floats<T, CG>(bk) * 4 / (int)sizeof(T) +
                  3 * stage_elems<CG>(bk, TILE);
  return wide > one ? wide : one;
}

template <typename T, int CG>
inline size_t smem_bytes(int bk, int slots) {
  return 128 + region_elems<T, CG>(bk) * sizeof(T) +
         slots * (sizeof(int4) + sizeof(int2));
}

// occ[q, kc] = any(x[q * sub_m : (q + 1) * sub_m, kc * bk : (kc + 1) * bk]
// != 0), one warp per (q, kc); block 0 also zeroes ncounts counts. With
// used (the nused chunk ids of the stored slots, -1 padded) a chunk no slot
// stores is 0 without reading x: at VGG16 layer 1 the stored chunks use a
// third of the patch matrix's columns.
template <typename T>
__global__ void __launch_bounds__(256)
    occ_kernel(const T* __restrict__ x, int* __restrict__ occ, int M, int K,
               int bk, int sub_m, int* __restrict__ counts, int ncounts,
               const int* __restrict__ used, int nused) {
  extern __shared__ unsigned stored[];  // bitmap of the stored chunks
  constexpr int EPC = 16 / sizeof(T);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < ncounts; i += blockDim.x) counts[i] = 0;
  const int kb = K / bk;
  if (used != nullptr) {
    for (int i = threadIdx.x; i < (kb + 31) / 32; i += blockDim.x)
      stored[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < nused; i += blockDim.x)
      if (used[i] >= 0) atomicOr(&stored[used[i] / 32], 1u << used[i] % 32);
    __syncthreads();
  }
  const int item = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (item >= M / sub_m * kb) return;
  const int q = item / kb, kc = item % kb;
  if (used != nullptr && !(stored[kc / 32] >> kc % 32 & 1)) {
    if (lane == 0) occ[item] = 0;
    return;
  }
  const int xch = bk / EPC;
  bool nz = false;
  for (int u = lane; u < sub_m * xch; u += 32) {
    const int r = u / xch, c = u % xch;
    const uint4 v = *reinterpret_cast<const uint4*>(
        x + (long)(q * sub_m + r) * K + (long)kc * bk + c * EPC);
    // != 0 as a float: -0 is zero
    if (sizeof(T) == 2)
      nz |= ((v.x | v.y | v.z | v.w) & 0x7FFF7FFFu) != 0;
    else
      nz |= ((v.x | v.y | v.z | v.w) & 0x7FFFFFFFu) != 0;
  }
  nz = __any_sync(0xffffffffu, nz);
  if (lane == 0) occ[item] = nz;
}

// The rows of the block at row0 (of which in_rows lie in x) whose sub_m
// sub-block is occupied in chunk kc (every one when one-sided).
template <typename T>
__device__ inline unsigned row_mask(const Args<T>& a, int row0, int kc,
                                    int kb, unsigned in_rows) {
  if (!a.two_sided) return in_rows;
  unsigned mask = 0;
  if (a.sub_m % TILE == 0) {  // one load per 8-row tile, all in flight
    // (a tile past M reads the last row's entry; in_rows drops it)
    const int last = a.M - 1;
    int live[ROWS / TILE];
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
      live[t] = a.occ[min(row0 + t * TILE, last) / a.sub_m * kb + kc];
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
      if (live[t]) mask |= 0xFFu << (t * TILE);
    return mask & in_rows;
  }
  for (int r = 0; r < ROWS && row0 + r < a.M; ++r)
    if (a.occ[(row0 + r) / a.sub_m * kb + kc]) mask |= 1u << r;
  return mask;
}

// The 32-row layout: one thread's 4 rows (8 apart, row stride ldx) x TR
// adjacent columns, k ascending, in groups of 4 k with the next group's
// operands loaded ahead; with PRED, row i takes no term unless lv[i].
template <int CG, int TR, bool PRED, typename T>
__device__ inline void mac_wide(float (&acc)[4][TR], const T* x, int ldx,
                                const T* w, int bk, const bool (&lv)[4]) {
  using X = Vec<T, 4>;
  using W = Vec<T, TR>;
  typename X::R xr[4];
  typename W::R wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xr[i] = ldv<T, 4>(x + i * TILE * ldx);
#pragma unroll
  for (int q = 0; q < 4; ++q) wr[q] = ldv<T, TR>(w + q * CG);
  for (int k = 0; k < bk; k += 4) {
    float a[4][4], b[4][TR];
#pragma unroll
    for (int i = 0; i < 4; ++i) X::widen(xr[i], a[i]);
#pragma unroll
    for (int q = 0; q < 4; ++q) W::widen(wr[q], b[q]);
    // the next group (past bk it reads the stage's padding, unused)
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = ldv<T, 4>(x + i * TILE * ldx + k + 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) wr[q] = ldv<T, TR>(w + (k + 4 + q) * CG);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (PRED && !lv[i]) continue;
#pragma unroll
        for (int c = 0; c < TR; ++c)
          acc[i][c] = fmaf(a[i][q], b[q][c], acc[i][c]);
      }
  }
}

template <int CG, int TR, typename T>
__device__ inline void mac_rows(float (&acc)[4][TR], const T* x, int ldx,
                                const T* w, int bk, unsigned mask, int rg) {
  bool lv[4];
  bool every = true, any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lv[i] = mask >> (rg + i * TILE) & 1;
    every &= lv[i];
    any |= lv[i];
  }
  if (every)
    mac_wide<CG, TR, false>(acc, x, ldx, w, bk, lv);
  else if (any)
    mac_wide<CG, TR, true>(acc, x, ldx, w, bk, lv);
}

// The one-tile layout: one thread's R rows x 2 adjacent columns from fp32
// operands (x k-major, the R values of one k adjacent; w [k][CG]), k
// ascending, in groups of 8 k with the next group's operands loaded while
// the current one is multiplied (past bk it reads padding, unused); with
// PRED, row i takes no term unless lv[i].
template <int CG, int R, bool PRED, int TC, typename W>
__device__ inline void mac_col(float (&acc)[4][TC], const float* x,
                               const W* w, int bk, const bool (&lv)[R]) {
  using X = Vec<float, R>;
  using V = Vec<W, 2>;
  typename X::R xr[8];
  typename V::R wr[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    xr[q] = ldv<float, R>(x + q * TILE);
    wr[q] = ldv<W, 2>(w + q * CG);
  }
  for (int k = 0; k < bk; k += 8) {
    float a[8][R], b[8][2];
#pragma unroll
    for (int q = 0; q < 8; ++q) X::widen(xr[q], a[q]), V::widen(wr[q], b[q]);
    x += 8 * TILE, w += 8 * CG;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      xr[q] = ldv<float, R>(x + q * TILE);
      wr[q] = ldv<W, 2>(w + q * CG);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (PRED && !lv[i]) continue;
        acc[i][0] = fmaf(a[q][i], b[q][0], acc[i][0]);
        acc[i][1] = fmaf(a[q][i], b[q][1], acc[i][1]);
      }
  }
}

template <int CG, int R, int TC, typename W>
__device__ inline void mac_tile(float (&acc)[4][TC], const float* x,
                                const W* w, int bk, unsigned mask, int r) {
  bool lv[R];
  bool every = true, any = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lv[i] = mask >> (r + i) & 1;
    every &= lv[i];
    any |= lv[i];
  }
  if (every)
    mac_col<CG, R, false>(acc, x, w, bk, lv);
  else if (any)
    mac_col<CG, R, true>(acc, x, w, bk, lv);
}

// The one-tile layout's operands of one staged entry: x [8, bk + PAD]
// widened (and transposed) into k-major xf[k][8], and with wide_w the bf16
// weight columns [bk, CG] widened into wf.
__device__ inline void widen8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = lo(q.x), v[1] = hi(q.x), v[2] = lo(q.y), v[3] = hi(q.y);
  v[4] = lo(q.z), v[5] = hi(q.z), v[6] = lo(q.w), v[7] = hi(q.w);
}
__device__ inline void widen8(const float* p, float (&v)[8]) {
  const float4 p0 = reinterpret_cast<const float4*>(p)[0];
  const float4 p1 = reinterpret_cast<const float4*>(p)[1];
  v[0] = p0.x, v[1] = p0.y, v[2] = p0.z, v[3] = p0.w;
  v[4] = p1.x, v[5] = p1.y, v[6] = p1.z, v[7] = p1.w;
}
template <typename T, int CG>
__device__ inline void widen_tile(const T* st, float* xf, float* wf, int bk) {
  const int ldx = bk + PAD;
  for (int u = threadIdx.x; u < TILE * (bk / 8); u += NT) {
    const int r = u % TILE, k0 = u / TILE * 8;
    float v[8];
    widen8(st + r * ldx + k0, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) xf[(k0 + i) * TILE + r] = v[i];
  }
  if (wide_w<T, CG>()) {
    const T* w = st + TILE * ldx;
    for (int u = threadIdx.x; u < bk * CG / 8; u += NT) {
      float v[8];
      widen8(w + u * 8, v);
      float4* d = reinterpret_cast<float4*>(wf + u * 8);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// act(h[, g]): None and ReLU inline, every other act out of line
__device__ inline float act_of(float h, float g, int act) {
  if (act == tile::ACT_NONE) return h;
  if (act == tile::ACT_RELU) return fmaxf(h, 0.f);
  return tile::activate(h, g, act);
}

// The work list's slots of stream `rank`: the merge of the segments of the
// pairs (n, m) whose bm rows lie in the block (bm divides 32), each live
// step ORing its pair's rows into its slot's mask; the rows live in either
// stream go into *s_union. Returns whether any pair has a live step. Every
// thread of the block must call it.
template <typename T, bool GATED>
__device__ inline bool walk_slots(const Args<T>& a, int2* flags,
                                  unsigned* s_union, unsigned rank, int n,
                                  int row0) {
  const int tid = threadIdx.x;
  for (int j = tid; j < a.max_nz; j += NT) flags[j] = make_int2(-1, 0);
  __syncthreads();
  const int mb = a.M / a.bm;
  const int* mine = a.ks[rank];
  const int* other = a.ks[rank ^ 1];
  unsigned seen = 0;
  for (int m = row0 / a.bm; m < mb && m * a.bm < row0 + ROWS; ++m) {
    const unsigned bits = (a.bm == ROWS ? ~0u : (1u << a.bm) - 1)
                          << (m * a.bm - row0);
    const int p = n * mb + m;
    for (int t = a.pair_ptr[p] + tid; t < a.pair_ptr[p + 1]; t += NT) {
      const int kc = mine[t];
      if (kc >= 0) {
        const int j = a.js[t];
        flags[j].x = kc;  // every pair names the same chunk for slot j
        atomicOr(&flags[j].y, (int)bits);
      }
      if (kc >= 0 || (GATED && other[t] >= 0)) seen |= bits;
    }
  }
  if (seen) atomicOr(s_union, seen);
  __syncthreads();
  return *s_union != 0;
}

// The block body, for one weight stream. With GATED a cluster of two CTAs
// owns the tile: rank 0 the in stream, rank 1 the gate stream, each with
// its own live list and ring, so a decode step's two chains of every
// element run in parallel; rank 1 hands its accumulators to rank 0 through
// distributed shared memory for the flush. WALK takes the slots from the
// work list, else from the dense grid. tx maps x [M, K] in [8, bk + PAD]
// boxes; tw maps this CTA's stream's vals [nb * max_nz, bk, bn] in
// [1, bk, CG] boxes.
template <typename T, int CG, bool GATED, bool WALK>
__device__ inline void run(const Args<T>& a, const CUtensorMap* tx,
                           const CUtensorMap* tw) {
  constexpr int TR = CG / 8;              // 32-row layout: columns a thread
  constexpr int R = CG / 16;              // one-tile layout: rows a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long full[MAX_STAGES];
  __shared__ int s_len;
  __shared__ unsigned s_union, s_nz;
  const int tid = threadIdx.x;
  unsigned rank = 0;
  if (GATED) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  int b = GATED ? blockIdx.x / 2 : blockIdx.x;
  const int cg = b % a.groups;
  b /= a.groups;
  const int n = b % a.nb;
  const int row0 = b / a.nb * ROWS;
  const int c0 = cg * CG;
  const int kb = a.K / a.bk;
  const int nrows = min(ROWS, a.M - row0);  // rows of the block in x
  const unsigned in_rows = nrows == ROWS ? ~0u : (1u << nrows) - 1;
  // 128-byte aligned for TMA, by pointer arithmetic on the shared array so
  // that the compiler keeps shared (not generic) loads
  T* region = reinterpret_cast<T*>(smem_raw + (-smem_addr(smem_raw) & 127u));
  int4* list = reinterpret_cast<int4*>(region + region_elems<T, CG>(a.bk));
  int2* flags = reinterpret_cast<int2*>(list + a.max_nz);

  // the slots: {chunk, row mask}; the layout below follows the rows live
  // in either stream, so both CTAs of a pair lay out their threads alike
  if (tid == 0) s_union = 0, s_nz = 0;
  bool busy;
  if constexpr (WALK) {
    busy = walk_slots<T, GATED>(a, flags, &s_union, rank, n, row0);
  } else {
    // a tile whose rows are all zero (the padding rows of a decode step)
    // writes act(0) and leaves after one round of loads (both CTAs of a
    // pair see the same rows and leave together); the same round reads the
    // slots' chunks, both streams'
    const int* idx = a.idx[rank] + (long)n * a.max_nz;
    const int* other = a.idx[rank ^ 1] + (long)n * a.max_nz;
    const int q0 = row0 / a.sub_m;
    const int nocc =
        a.two_sided ? ((row0 + nrows - 1) / a.sub_m - q0 + 1) * kb : 0;
    int any = !a.two_sided;
    for (int i = tid; i < max(nocc, a.max_nz); i += NT) {
      if (i < nocc) any |= a.occ[q0 * kb + i];
      if (i < a.max_nz) flags[i] = make_int2(idx[i], GATED ? other[i] : -1);
    }
    busy = __syncthreads_or(any);
    if (busy) {
      unsigned seen = 0;
      for (int j = tid; j < a.max_nz; j += NT) {
        const int kc = flags[j].x, ko = flags[j].y;
        const unsigned m = kc < 0 ? 0u : row_mask(a, row0, kc, kb, in_rows);
        flags[j] = make_int2(kc, (int)m);
        seen |= m | (ko < 0 ? 0u : row_mask(a, row0, ko, kb, in_rows));
      }
      if (seen) atomicOr(&s_union, seen);
    }
  }
  if (!busy) {  // act(0), which is 0 for every act: nothing for occ_out
    if (rank == 0) {
      const float zero = act_of(0.f, 0.f, a.act);
      T* out = a.out + (long)row0 * a.nb * a.bn + (long)n * a.bn + c0;
      for (int u = tid; u < nrows * CG; u += NT)
        if (c0 + u % CG < a.bn)
          tile::store(out + (long)(u / CG) * a.nb * a.bn + u % CG, zero);
    }
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the live list: {j, chunk, row mask}, ascending j; the dense grid's
  // counts by the rule: two-sided, the live sub-blocks whose first row the
  // block holds; one-sided, a stored slot per row block starting in it
  // (with row blocks of 32 rows or more one count for the block, else lane
  // r of warp 0 counts for row r)
  if (tid < 32) {
    unsigned first = 0, heads = 0;
    if (!WALK && a.counts != nullptr) {
      for (int r = (a.sub_m - row0 % a.sub_m) % a.sub_m; r < ROWS;
           r += a.sub_m)
        first |= 1u << r;
      for (int r = (a.bm - row0 % a.bm) % a.bm; r < ROWS; r += a.bm)
        heads |= 1u << r;
      first &= in_rows, heads &= in_rows;
    }
    int len = 0, cnt = 0;
    for (int j0 = 0; j0 < a.max_nz; j0 += 32) {
      const int j = j0 + tid;
      const int2 f = j < a.max_nz ? flags[j] : make_int2(-1, 0);
      const unsigned mask = (unsigned)f.y;
      const unsigned ballot = __ballot_sync(0xffffffffu, mask != 0);
      if (mask)
        list[len + __popc(ballot & ((1u << tid) - 1))] =
            make_int4(j, f.x, f.y, 0);
      len += __popc(ballot);
      if (!WALK && a.counts != nullptr) {
        const unsigned c = a.two_sided ? mask & first : (mask ? heads : 0u);
        if (a.bm >= ROWS) {
          cnt += __popc(c);
        } else {
          for (int r = 0; r < ROWS; ++r) {
            const int hits = __popc(__ballot_sync(0xffffffffu, c >> r & 1));
            if (tid == r) cnt += hits;
          }
        }
      }
    }
    if (tid == 0) s_len = len;
    if (!WALK && a.counts != nullptr && cg == 0) {
      if (a.bm >= ROWS) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
        if (tid == 0 && cnt)
          atomicAdd(a.counts + (long)n * (a.M / a.bm) + row0 / a.bm, cnt);
      } else if (cnt) {
        atomicAdd(a.counts + (long)n * (a.M / a.bm) + (row0 + tid) / a.bm,
                  cnt);
      }
    }
  }
  __syncthreads();
  const int len = s_len;
  const unsigned live = s_union;
  // one 8-row tile holds every live row: the one-tile layout
  const int t1 = live ? (__ffs(live) - 1) / TILE : 0;
  const bool one_tile = (live & ~(0xFFu << (t1 * TILE))) == 0;
  const int xr0 = one_tile ? t1 * TILE : 0, nx = one_tile ? TILE : ROWS;
  const int ldx = a.bk + PAD;
  const int stage = stage_elems<CG>(a.bk, nx);
  // the one-tile layout keeps its fp32 operands at the front of the region
  float* xf = reinterpret_cast<float*>(region);
  float* wf = xf + (a.bk + PAD) * TILE;
  const int front = one_tile ? tile_floats<T, CG>(a.bk) * 4 / sizeof(T) : 0;
  T* ring = region + front;
  const int S = min(MAX_STAGES, (region_elems<T, CG>(a.bk) - front) / stage);
  // x boxes that start inside x (rows past M in a box arrive as zeros)
  const int xboxes = min(nx, nrows - xr0 + TILE - 1) / TILE;
  const unsigned stage_bytes =
      (xboxes * TILE * ldx + a.bk * CG) * static_cast<unsigned>(sizeof(T));

  // thread 0 starts entry e's copies into stage e % S
  auto load = [&](int e) {
    T* st = ring + (e % S) * stage;
    const int4 ent = list[e];
    mbar_expect(&full[e % S], stage_bytes);
    for (int r = 0; r < xboxes * TILE; r += TILE)
      tma2(st + r * ldx, tx, ent.y * a.bk, row0 + xr0 + r, &full[e % S]);
    tma3(st + nx * ldx, tw, c0, 0, n * a.max_nz + ent.x, &full[e % S]);
  };

  // 32-row layout: rows rg + 8 i, columns TR ct .. TR ct + TR - 1;
  // one-tile layout: rows R rp .. R rp + R - 1 of the tile, columns 2 cq,
  // 2 cq + 1
  const int ct = tid % (CG / TR), rg = tid / (CG / TR);
  const int cq = tid % (CG / 2), rp = tid / (CG / 2);

  float acc[4][TR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TR; ++c) acc[i][c] = 0.f;

  if (tid == 0)
    for (int e = 0; e < S - 1 && e < len; ++e) load(e);
  for (int e = 0; e < len; ++e) {
    const int se = e % S;
    const T* st = ring + se * stage;
    mbar_wait(&full[se], (e / S) & 1);  // entry e has landed
    __syncthreads();  // every thread is done with e - 1
    if (tid == 0 && e + S - 1 < len) {
      // stage (e - 1) % S was last read before the barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(e + S - 1);
    }
    const unsigned mask = (unsigned)list[e].z;
    if (one_tile) {
      widen_tile<T, CG>(st, xf, wf, a.bk);
      __syncthreads();  // the fp32 operands of e are complete
      if (wide_w<T, CG>())
        mac_tile<CG, R>(acc, xf + R * rp, wf + 2 * cq, a.bk, mask,
                        xr0 + R * rp);
      else
        mac_tile<CG, R>(acc, xf + R * rp, st + nx * ldx + 2 * cq, a.bk, mask,
                        xr0 + R * rp);
    } else {
      mac_rows<CG, TR>(acc, st + rg * ldx, ldx, st + nx * ldx + TR * ct, a.bk,
                       mask, rg);
    }
  }

  // the gate accumulators move to rank 0 (same thread, same elements),
  // into its region once both CTAs are done with theirs
  float gate[4][TR];
  if (GATED) {
    float* handoff = reinterpret_cast<float*>(region);
    unsigned peer;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(peer)
                 : "r"(smem_addr(handoff)));
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::
                     : "memory");
    if (rank == 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < TR; ++c)
          asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                           peer + 4u * ((i * TR + c) * NT + tid)),
                       "f"(acc[i][c])
                       : "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::
                     : "memory");
    if (rank == 1) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < TR; ++c)
        gate[i][c] = handoff[(i * TR + c) * NT + tid];
  }

  // the flush: every (row, column) of the block in x once
  const long ldo = (long)a.nb * a.bn;
  T* out = a.out + (long)row0 * ldo + (long)n * a.bn;
  const bool emit = a.occ_out != nullptr;
  unsigned nz = 0;  // rows this thread stored a non-zero to
  if (one_tile) {
    // tile t1's rows from the accumulators, the other tiles' rows zero
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = t * TILE + R * rp + i, col = c0 + 2 * cq + c;
          const bool mine = t == t1;
          const float h = mine ? acc[i][c] : 0.f;
          const float g = GATED && mine ? gate[i][c] : 0.f;
          const float v = act_of(h, g, a.act);
          if (col < a.bn && row < nrows) {
            tile::store(out + (long)row * ldo + col, v);
            if (emit && stored_nonzero(v, out)) nz |= 1u << row;
          }
        }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        const int row = rg + i * TILE, col = c0 + TR * ct + c;
        const float v = act_of(acc[i][c], GATED ? gate[i][c] : 0.f, a.act);
        if (col < a.bn && row < nrows) {
          tile::store(out + (long)row * ldo + col, v);
          if (emit && stored_nonzero(v, out)) nz |= 1u << row;
        }
      }
  }
  if (emit) {
    if (nz) atomicOr(&s_nz, nz);
    __syncthreads();
    if (tid < nrows && (s_nz >> tid & 1))
      atomicOr(a.occ_out + (long)((row0 + tid) / a.sub_m) * a.nb + n, 1);
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(NT)
    grid_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw) {
  run<T, CG, false, false>(a, &tx, &tw);
}

// Two weight streams: CTA pairs, one per stream (tw0 the first, in; tw1
// the second, gate).
template <typename T, int CG>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT)
    pair_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw0,
                const __grid_constant__ CUtensorMap tw1) {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  run<T, CG, true, false>(a, &tx, rank ? &tw1 : &tw0);
}

// The work list's kernels. The minimum of one block per SM lifts ptxas's
// register target: without it the one-stream bf16 instantiation at 32
// columns spilled at 64 registers.
template <typename T, int CG>
__global__ void __launch_bounds__(NT, 1)
    walk_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw) {
  run<T, CG, false, true>(a, &tx, &tw);
}

template <typename T, int CG>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1)
    walk_pair_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw0,
                     const __grid_constant__ CUtensorMap tw1) {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  run<T, CG, true, true>(a, &tx, rank ? &tw1 : &tw0);
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no link
// against libcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major tensor of `rank` dims (innermost first) and a box, laid out
// in shared memory as `swizzle` says.
template <typename T>
inline bool encode(CUtensorMap* map, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t s = sizeof(T);
  for (int d = 0; d + 1 < rank; ++d) strides[d] = s *= dims[d];
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int CG, bool GATED, bool WALK>
int launch_cg(const Args<T>& a, const T* x, const T* const* vals, long blocks,
              cudaStream_t st) {
  constexpr int NS = GATED ? 2 : 1;
  CUtensorMap tx, tw[2];
  const cuuint64_t xd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint32_t xb[2] = {(cuuint32_t)(a.bk + PAD), TILE};
  if (!encode<T>(&tx, x, 2, xd, xb))
    return static_cast<int>(cudaErrorInvalidValue);
  tw[0] = tw[1] = tx;  // no weights to map when max_nz == 0
  if (a.max_nz > 0) {
    const cuuint64_t wd[3] = {(cuuint64_t)a.bn, (cuuint64_t)a.bk,
                              (cuuint64_t)a.nb * a.max_nz};
    const cuuint32_t wb[3] = {CG, (cuuint32_t)a.bk, 1};
    for (int s = 0; s < NS; ++s)
      if (!encode<T>(&tw[s], vals[s], 3, wd, wb))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T, CG>(a.bk, a.max_nz);
  cudaError_t e = cudaSuccess;
  if constexpr (GATED) {
    const auto kernel = [] {
      if constexpr (WALK) return walk_pair_kernel<T, CG>;
      else return pair_kernel<T, CG>;
    }();
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<(unsigned)(2 * blocks), NT, smem, st>>>(a, tx, tw[0], tw[1]);
  } else {
    const auto kernel = [] {
      if constexpr (WALK) return walk_kernel<T, CG>;
      else return grid_kernel<T, CG>;
    }();
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<(unsigned)blocks, NT, smem, st>>>(a, tx, tw[0]);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy launch (two-sided dense grid; it also zeroes the counts),
// then the grid over M rows with col_group (16 or 32) columns per block;
// vals[s] is stream s's weight tiles. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the grid does not take (bm neither
// dividing nor a multiple of 32, or not tiling M; sub_m not dividing bm; bk
// or bn not multiples of 8; bk > 248; bn > 128; for the work list bm > 32).
template <typename T, bool GATED, bool WALK>
int launch(const Args<T>& a, const T* x, const T* const* vals, int col_group,
           cudaStream_t st) {
  if (a.bm <= 0 || (a.bm % ROWS && ROWS % a.bm) || a.M % a.bm ||
      a.sub_m <= 0 || a.bm % a.sub_m || a.bk <= 0 || a.bk % 8 ||
      a.bk + PAD > 256 || a.K % a.bk || a.bn % 8 || a.bn > 128 ||
      (WALK && ROWS % a.bm) || (col_group != 16 && col_group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.occ_out != nullptr) {
    const cudaError_t e = cudaMemsetAsync(
        a.occ_out, 0, sizeof(int) * (size_t)(a.M / a.sub_m) * a.nb, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long items =
      !WALK && a.two_sided ? (long)(a.M / a.sub_m) * (a.K / a.bk) : 0;
  const int ncounts = a.counts ? a.nb * (a.M / a.bm) : 0;
  if (items + ncounts > 0) {
    const long blocks = items > 0 ? (items + 7) / 8 : 1;
    const int kb = a.K / a.bk;
    const int* used = a.used_only ? a.idx[0] : nullptr;
    occ_kernel<T><<<(unsigned)blocks, 256,
                    used ? (kb + 31) / 32 * sizeof(unsigned) : 0, st>>>(
        x, a.occ, a.M, a.K, a.bk, a.sub_m, a.counts, ncounts, used,
        a.nb * a.max_nz);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks = (long)((a.M + ROWS - 1) / ROWS) * a.nb * a.groups;
  if (blocks == 0) return 0;
  if (col_group == 16)
    return launch_cg<T, 16, GATED, WALK>(a, x, vals, blocks, st);
  return launch_cg<T, 32, GATED, WALK>(a, x, vals, blocks, st);
}

}  // namespace fgrid
