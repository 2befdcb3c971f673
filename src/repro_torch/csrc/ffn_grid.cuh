// The dense-grid body shared by the predicated sparse matmul (K3,
// bitmask_spmm.cu) and the fused FFN (K4, fused_ffn.cu), laid out for the
// H100's SMs and its tensor memory accelerator (TMA).
//
// Geometry. One CTA of 64 threads owns a 32-row x CG-column tile of one
// n-block's output for one weight stream (CG = 16 or 32, chosen by the
// wrapper: grid_geometry in repro_torch/kernels/bitmask_spmm.py). CTAs are
// numbered (row_block * nb + n) * groups + cg, 32-row blocks outermost: a
// decode step's live rows lie in the first 32 rows of a row block, so its
// busy CTAs come first in the launch and spread over every SM (with the
// row tiles of one column group adjacent they fell at a fixed stride and
// crowded onto a quarter of the SMs). The gated FFN launches CTA pairs
// (clusters of 2): rank 0 runs the in stream, rank 1 the gate stream, so
// the two chains of every element run in parallel, and rank 1 hands its
// accumulators to rank 0 through distributed shared memory for the flush.
//
// Occupancy. A first launch, occ_kernel, computes the activation occupancy
// occ[row / sub_m, chunk] (any x != 0) with one warp per sub-block and
// chunk, and zeroes the MAC counts.
//
// Live list. A CTA whose 32 rows are all zero (a decode step's padding)
// stores act(0) and leaves after one round of occupancy loads, which also
// fetches the slots' chunk indices: at Qwen3-4B's decode three CTAs in four
// are such, and they no longer hold SM slots the busy CTAs need. Any other
// CTA compacts its stream's live slots into shared memory, in ascending j:
// a slot whose chunk is stored (index >= 0) and, when two-sided, whose
// occupancy bit is set for some row of the CTA; warp 0 scans the flags.
// Each entry keeps its 32-bit row mask; a dead row takes no term.
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
// rows x 2 columns; the ring then holds 3 entries. Otherwise (a prefill)
// each thread owns 4 rows (rg + 8 i) x CG / 8 adjacent columns, widening
// bf16 as it reads, and the ring holds 2 entries. Inside an entry each
// thread loads the next k-group's operands while it multiplies the current
// one.
//
// Sum order. Every output element is one fp32 chain per stream: +0, then
// acc = fmaf(x, w, acc) for k ascending within a chunk and j ascending
// across entries: the order of tile::mac_chunk, so the walker (walk.cu) on
// the compact schedule gives bit for bit the same output. The flush
// computes what tile::flush computes (None and ReLU inline, every other act
// through the out-of-line tile::activate, one rounding at the store). No
// atomics touch the output, and nothing is carried between tiles: a row's
// result does not depend on the other rows of its block.
//
// Counts. With count_macs each CTA adds (one integer atomic) to
// counts[n, m]: in column group 0, the live sub-blocks whose first row lies
// in its rows (two-sided), or one per stored slot in the first 32 rows of
// each row block (one-sided).
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
  const int* idx[2];        // per stream [nb, max_nz], -1 padded
  int* occ;                 // [M / sub_m, K / bk], written by occ_kernel
  T* out;                   // [M, nb * bn]
  int* counts;              // [nb, M / bm], or null
  int M, K, nb, max_nz, bk, bn, bm, sub_m, two_sided, act, groups;
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
// != 0), one warp per (q, kc); block 0 also zeroes ncounts counts.
template <typename T>
__global__ void __launch_bounds__(256)
    occ_kernel(const T* __restrict__ x, int* __restrict__ occ, int M, int K,
               int bk, int sub_m, int* __restrict__ counts, int ncounts) {
  constexpr int EPC = 16 / sizeof(T);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < ncounts; i += blockDim.x) counts[i] = 0;
  const int kb = K / bk;
  const int item = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (item >= M / sub_m * kb) return;
  const int q = item / kb, kc = item % kb;
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

// The rows of the block at row0 whose sub_m sub-block is occupied in chunk
// kc (every row when one-sided).
template <typename T>
__device__ inline unsigned row_mask(const Args<T>& a, int row0, int kc,
                                    int kb) {
  if (!a.two_sided) return ~0u;
  unsigned mask = 0;
  if (a.sub_m % TILE == 0) {  // one load per 8-row tile, all in flight
    int live[ROWS / TILE];
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
      live[t] = a.occ[(row0 + t * TILE) / a.sub_m * kb + kc];
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
      if (live[t]) mask |= 0xFFu << (t * TILE);
    return mask;
  }
  for (int r = 0; r < ROWS; ++r)
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

// act(h[, g]) as tile::flush computes it
__device__ inline float act_of(float h, float g, int act) {
  if (act == tile::ACT_NONE) return h;
  if (act == tile::ACT_RELU) return fmaxf(h, 0.f);
  return tile::activate(h, g, act);
}

// The block body, for one weight stream. With GATED a cluster of two CTAs
// owns the tile: rank 0 the in stream, rank 1 the gate stream, each with
// its own live list and ring, so a decode step's two chains of every
// element run in parallel; rank 1 hands its accumulators to rank 0 through
// distributed shared memory for the flush. tx maps x [M, K] in
// [8, bk + PAD] boxes; tw maps this CTA's stream's vals
// [nb * max_nz, bk, bn] in [1, bk, CG] boxes.
template <typename T, int CG, bool GATED>
__device__ inline void run(const Args<T>& a, const CUtensorMap* tx,
                           const CUtensorMap* tw) {
  constexpr int TR = CG / 8;              // 32-row layout: columns a thread
  constexpr int R = CG / 16;              // one-tile layout: rows a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long full[MAX_STAGES];
  __shared__ int s_len;
  __shared__ unsigned s_union;
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
  const int* idx = a.idx[rank] + (long)n * a.max_nz;
  const int* other = a.idx[rank ^ 1] + (long)n * a.max_nz;
  // 128-byte aligned for TMA, by pointer arithmetic on the shared array so
  // that the compiler keeps shared (not generic) loads
  T* region = reinterpret_cast<T*>(smem_raw + (-smem_addr(smem_raw) & 127u));
  int4* list = reinterpret_cast<int4*>(region + region_elems<T, CG>(a.bk));
  int2* flags = reinterpret_cast<int2*>(list + a.max_nz);

  // a tile whose rows are all zero (the padding rows of a decode step)
  // writes act(0) and leaves after one round of loads (both CTAs of a pair
  // see the same rows and leave together); the same round reads the slots'
  // chunks, both streams'
  const int q0 = row0 / a.sub_m;
  const int nocc = a.two_sided ? ((row0 + ROWS - 1) / a.sub_m - q0 + 1) * kb
                               : 0;
  int any = !a.two_sided;
  if (tid == 0) s_union = 0;
  for (int i = tid; i < max(nocc, a.max_nz); i += NT) {
    if (i < nocc) any |= a.occ[q0 * kb + i];
    if (i < a.max_nz) flags[i] = make_int2(idx[i], GATED ? other[i] : -1);
  }
  if (!__syncthreads_or(any)) {
    if (rank == 0) {
      const float zero = act_of(0.f, 0.f, a.act);
      T* out = a.out + (long)row0 * a.nb * a.bn + (long)n * a.bn + c0;
      for (int u = tid; u < ROWS * CG; u += NT)
        if (c0 + u % CG < a.bn)
          tile::store(out + (long)(u / CG) * a.nb * a.bn + u % CG, zero);
    }
    return;
  }

  // every slot: {chunk, row mask}; the layout below follows the rows live
  // in either stream, so both CTAs of a pair lay out their threads alike
  unsigned seen = 0;
  for (int j = tid; j < a.max_nz; j += NT) {
    const int kc = flags[j].x, ko = flags[j].y;
    const unsigned m = kc < 0 ? 0u : row_mask(a, row0, kc, kb);
    flags[j] = make_int2(kc, (int)m);
    seen |= m | (ko < 0 ? 0u : row_mask(a, row0, ko, kb));
  }
  if (seen) atomicOr(&s_union, seen);
  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the live list: {j, chunk, row mask}, ascending j
  if (tid < 32) {
    unsigned first = 0;  // rows of the block that start a sub_m sub-block
    for (int r = (a.sub_m - row0 % a.sub_m) % a.sub_m; r < ROWS; r += a.sub_m)
      first |= 1u << r;
    const bool head = row0 % a.bm == 0;  // first rows of a row block
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
      cnt += a.two_sided ? __popc(mask & first) : (mask != 0 && head);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    if (tid == 0) {
      s_len = len;
      if (a.counts != nullptr && cg == 0 && cnt)
        atomicAdd(a.counts + (long)n * (a.M / a.bm) + row0 / a.bm, cnt);
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
  const unsigned stage_bytes =
      (nx * ldx + a.bk * CG) * static_cast<unsigned>(sizeof(T));

  // thread 0 starts entry e's copies into stage e % S
  auto load = [&](int e) {
    T* st = ring + (e % S) * stage;
    const int4 ent = list[e];
    mbar_expect(&full[e % S], stage_bytes);
    for (int r = 0; r < nx; r += TILE)
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

  // the flush: every (row, column) of the block once
  const long ldo = (long)a.nb * a.bn;
  T* out = a.out + (long)row0 * ldo + (long)n * a.bn;
  if (one_tile) {
    // tile t1's rows from the accumulators, the other tiles' rows zero
#pragma unroll
    for (int t = 0; t < ROWS / TILE; ++t)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c0 + 2 * cq + c;
          const bool mine = t == t1;
          const float h = mine ? acc[i][c] : 0.f;
          const float g = GATED && mine ? gate[i][c] : 0.f;
          const float v = act_of(h, g, a.act);
          if (col < a.bn)
            tile::store(out + (long)(t * TILE + R * rp + i) * ldo + col, v);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < TR; ++c) {
        const int col = c0 + TR * ct + c;
        const float v = act_of(acc[i][c], GATED ? gate[i][c] : 0.f, a.act);
        if (col < a.bn)
          tile::store(out + (long)(rg + i * TILE) * ldo + col, v);
      }
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(NT)
    grid_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw) {
  run<T, CG, false>(a, &tx, &tw);
}

// The gated FFN: CTA pairs, one per stream (tw0 in, tw1 gate).
template <typename T, int CG>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT)
    pair_kernel(const Args<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw0,
                const __grid_constant__ CUtensorMap tw1) {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  run<T, CG, true>(a, &tx, rank ? &tw1 : &tw0);
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

// A row-major tensor of `rank` dims (innermost first) and a box.
template <typename T>
inline bool encode(CUtensorMap* map, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint32_t* box) {
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
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int CG, bool GATED>
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
    const auto kernel = pair_kernel<T, CG>;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<(unsigned)(2 * blocks), NT, smem, st>>>(a, tx, tw[0], tw[1]);
  } else {
    const auto kernel = grid_kernel<T, CG>;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<(unsigned)blocks, NT, smem, st>>>(a, tx, tw[0]);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy launch, then the grid over M rows with col_group (16 or
// 32) columns per block; vals[s] is stream s's weight tiles. Returns a
// cudaError_t: cudaErrorInvalidValue for a shape the grid does not take
// (bm not a multiple of 32, bk or bn not multiples of 8, bk > 248,
// bn > 128).
template <typename T, bool GATED>
int launch(const Args<T>& a, const T* x, const T* const* vals, int col_group,
           cudaStream_t st) {
  if (a.bm % ROWS || a.M % a.bm || a.bm % a.sub_m || a.bk <= 0 ||
      a.bk % 8 || a.bk + PAD > 256 || a.K % a.bk || a.bn % 8 || a.bn > 128 ||
      (col_group != 16 && col_group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const long items = (long)(a.M / a.sub_m) * (a.K / a.bk);
  const int ncounts = a.counts ? a.nb * (a.M / a.bm) : 0;
  if (items + ncounts > 0) {
    const long blocks = items > 0 ? (items + 7) / 8 : 1;
    occ_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
        x, a.occ, a.M, a.K, a.bk, a.sub_m, a.counts, ncounts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks = (long)(a.M / ROWS) * a.nb * a.groups;
  if (blocks == 0) return 0;
  if (col_group == 16)
    return launch_cg<T, 16, GATED>(a, x, vals, blocks, st);
  return launch_cg<T, 32, GATED>(a, x, vals, blocks, st);
}

}  // namespace fgrid
