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
// Two modes, chosen by the wrapper (walk_mode in
// repro_torch/kernels/worklist_core.py) from the row block bm_rows.
//
// The tile mode (bm_rows not dividing 32: the conv path's 128-row blocks).
// One CTA owns a tile of RT rows x CT columns (32, 64 or 128) of one pair's
// output, so every output element has exactly one owner and nothing is
// carried between CTAs (the TPU grid carried the accumulators in VMEM
// scratch from step to step). The wrapper picks the tile and the rows a
// thread owns from the pairs' shape and depth and the card's SM count
// (walk_tiles in repro_torch/kernels/grid.py); CTAs are numbered row block
// outermost, so the CTAs that read one row block's x run together and its
// rows come from HBM once for all n-blocks. Warp 0 walks the pair's segment
// into a list of {chunk, slot, stream} items in schedule order; a producer
// warp copies each item's x rows and weight columns, 32 k a stage, into a
// ring of 2 stages in shared memory with TMA tensor copies that complete
// on the stage's full mbarrier, ahead across chunk and step boundaries, and
// refills a stage once every computing thread has arrived on its empty
// mbarrier, so the computing warps never wait on each other. Each
// computing thread owns TM = 8 or 4 rows x 8 columns (4 rows for two
// streams); a warp owns a band of TM * 256 / CT consecutive rows. For each
// stage a warp widens and transposes its band of the staged x into its own
// fp32 copy, k-major, voting on the way whether the band is all zero there
// (-0 is zero): then it skips the stage (chip_smoke.py prints the share of
// zero terms at VGG16 layers 1 and 8). Otherwise each k step reads TM / 4
// 16-byte x vectors (a broadcast to the lanes of a row group) and two
// 16-byte weight vectors (one for bf16, widened as read) for 8 * TM FMAs,
// with the next k's operands loaded during the current one's FMAs. The x
// slab lands in the tensor copies' 128-byte (bf16: 64-byte) swizzle, so the
// lanes that read one 16-byte chunk of consecutive rows hit distinct bank
// groups and no row costs more than its own bytes. A shape the tensor copies
// refuse (a row stride or an operand not 16-byte aligned) runs the same
// body with plain copies into one stage, chosen by the wrapper from the
// shape; nothing falls back at run time.
//
// The tap-slab operand (lazy im2col, the tile mode, one stream). Instead of
// a patch matrix [M, K] x may be the conv's NHWC input map [B, H, W, cin]
// with the layer's geometry: output row r is pixel p = r % m_pad of image
// r / m_pad, a real pixel when p < m_img = oh * ow, and K-chunk c = tap *
// (cin / bk) + sub, (dy, dx) = divmod(tap, kw), of that row is channels
// sub * bk .. of input pixel (oy * sh + dy - ph0, ox * sw + dx - pw0),
// zero outside the map: the column of the tap-major patch matrix the chunk
// stands for, without the patch matrix. The producer fetches a stage with
// one im2col tensor copy of the unpadded map (cuTensorMapEncodeIm2col:
// KS channels a pixel, the tile's rows as pixels a column, element strides
// (sw, sh), the window's (dx, dy) as the copy's offsets); pixels outside
// the map arrive as zeros, in the same swizzle as a patch-matrix box. The
// copy runs on through W, then H, then N, so a tile whose rows pass m_img
// (VGG16 at 56, 28 and 14 px against 128-row blocks) receives the next
// image's first pixels there: the warps zero rows p >= m_img while they
// transpose their band (and vote on the zeroed band), so those rows give
// act(0) and occupancy 0 as the patch matrix's zero pad rows do, and a tile
// with no real row skips its walk. Shapes the im2col copies refuse (pixels
// not a multiple of 16 bytes, a stride above 8) take the plain copies with
// the same address map. Every stage holds the values the patch-matrix
// operand stages, so the result is bit for bit K1's on the patch matrix.
//
// The residual flush (the tile mode, fp32, one stream, the patch matrix: a
// ResNet block's last conv). res is the shortcut in the output's own
// geometry [M, nb * bn], and the flush stores act(acc + res) at every
// element it stores, reading res there and nowhere else: one fp32 add, so
// the result is bit for bit K1 without it followed by an add and act. Its
// launches are tile_kernel_residual, the body of tile_kernel with the add;
// tile_kernel itself has none.
//
// The grid mode (bm_rows dividing 32: the compact FFN schedule's 8-row
// blocks, also 16 and 32). This mode runs on the grid of the dense FFN
// kernels (ffn_grid.cuh): 64-thread CTAs over 32-row x 16- or 32-column
// tiles of an n-block, busy CTAs first in the launch, a TMA ring, two thread
// layouts, and for two streams CTA pairs in a cluster whose gate CTA hands
// its accumulators to the in CTA over distributed shared memory. A CTA
// merges the work-list segments of the 32 / bm_rows pairs its rows cover
// into one live list in ascending j, each entry with its rows per stream,
// so a weight tile is staged once for all of them and a decode step gets
// a CTA per column group of every n-block (608 busy CTAs for Qwen3-4B's
// in/gate projection). Dead pairs flush act(0) like every other row.
//
// Sum order, either mode. Every element is one fp32 chain per stream: +0,
// then k ascending within a chunk and j ascending across steps, one fmaf
// per term; a term whose x is zero adds fmaf(0, w, acc) == acc, so skipping
// it changes no value. So the fp32 sum order of every element is fixed by
// the schedule alone: no split along k, no atomics on the output,
// deterministic output, and a batch of images gives bit for bit what each
// image gives alone. x, the weights and out are fp32 or bf16 (T): bf16 is
// staged raw, widened to fp32 when read and rounded once at the store; the
// arithmetic is fp32 either way. The work-list FFN schedule at bm_rows =
// sub_m = 8 gives bit for bit what the predicated grid (bitmask_spmm.cu,
// fused_ffn.cu) gives, and the tile mode what the dense-grid conv
// (conv_grid.cu) gives: the same terms in the same order, flushed through
// the same code (tile.cuh).
//
// The paper's §3.3 output-buffer colouring (ncolors, mb_per_img) selected
// which VMEM accumulator a row block used on the TPU, because consecutive
// grid steps there shared scratch. Here each CTA owns its accumulator, so
// no two row blocks ever share one and the colour cannot change the result;
// the arguments are accepted for interface parity and unused.
//
// What bounds it on this card. fp32 FMA on the CUDA cores (no tensor
// cores: TF32 or bf16 products summed in another order would break the
// bitwise invariants and the 1e-5 agreement with the fp32 reference), so
// the compute roof is 67 TFLOP/s, one warp FMA a clock on each of an SM's
// four schedulers: every other instruction a scheduler issues takes an FMA
// slot. A live 128x128x128 step is 4.2 MFLOP against 128 KB of x and w
// tiles, 32 FLOP/B, above the ridge of 67 TFLOP/s over 3.35 TB/s = 20
// FLOP/B, so the conv path is bound by operations, but for VGG16's first
// layers, whose 64-column n-blocks read each x row once and write as many
// bytes as they read. What holds the mode back (PERF.md): a k step's four
// 16-byte shared loads move as many bytes into registers as the SM's
// shared memory delivers while the FMA pipes run at full rate (a thread
// owning 8 x 16 outputs, a quarter fewer bytes a FMA, runs out of
// registers), and at VGG16 layer 8 the 112 pairs of 128 x 128 outputs do
// not spread evenly over 132 SMs (the busiest takes 4 tiles of 32 x 128
// where the mean is 3.4). At decode an 8-row step is 0.26 MFLOP
// against a 64 KB weight tile, below the ridge, but each element's chain of
// dependent fmaf runs on the latency of a few busy CTAs per SM, as in the
// dense FFN kernels.
#include <type_traits>

#include "ffn_grid.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tile mode
// ---------------------------------------------------------------------------
constexpr int KS = 32;           // k depth of a ring stage
constexpr int STAGES = 2;        // ring stages of tensor copies
constexpr int MAX_THREADS = 288;  // 256 computing, one producer warp
constexpr int MAX_ROWS = 128;    // rows of a CTA tile

// 16 bytes of staged operand, 4 fp32 or 8 bf16 loaded raw, and element q of
// it widened to fp32 (q a constant once unrolled).
template <typename T>
struct V16;
template <>
struct V16<float> {
  using R = float4;
  static constexpr int N = 4;
  static constexpr unsigned MAG = 0x7FFFFFFFu;  // the bits of |v|
  static __device__ float at(const R& r, int q) {
    return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  }
  static __device__ R pack(const float (&y)[4]) {
    return make_float4(y[0], y[1], y[2], y[3]);
  }
};
template <>
struct V16<__nv_bfloat16> {
  using R = uint4;
  static constexpr int N = 8;
  static constexpr unsigned MAG = 0x7FFF7FFFu;
  static __device__ float at(const R& r, int q) {
    const unsigned w = q < 2 ? r.x : q < 4 ? r.y : q < 6 ? r.z : r.w;
    return q & 1 ? fgrid::hi(w) : fgrid::lo(w);
  }
  static __device__ unsigned two(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ R pack(const float (&y)[8]) {
    return make_uint4(two(y[0], y[1]), two(y[2], y[3]), two(y[4], y[5]),
                      two(y[6], y[7]));
  }
};
template <typename T>
__device__ inline typename V16<T>::R ld16(const T* p) {
  return *reinterpret_cast<const typename V16<T>::R*>(p);
}

// An mbarrier that completes a phase after `count` arrivals, and one
// arrival (the ring's empty barriers: every consumer thread arrives once
// it is done with a stage).
__device__ inline void mbar_init_count(unsigned long long* bar,
                                       unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   fgrid::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ inline void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   fgrid::smem_addr(bar))
               : "memory");
}

// The layout of a CTA tile CT columns wide whose threads own TM rows x 8
// columns. Lane l of a warp is column lane l % CC of row group l / CC; the
// thread's rows are band0 + TM * g + i (i < TM), its columns VK * cl + v *
// CT / NV + c (v < NV, c < VK): 16-byte vectors that the lanes of a row
// group read side by side. Each warp widens and transposes its band of a
// staged x into its own fp32 copy xt[k][row], XTP floats a k apart, so that
// a k step reads TM / 4 + NV 16-byte vectors for 8 * TM FMAs.
template <typename T, int TM, int CT>
struct Lay {
  static constexpr int VK = V16<T>::N;  // k of an x vector, columns of a w one
  static constexpr int NV = 8 / VK;     // w vectors of a thread's columns
  static constexpr int CC = CT / 8;     // column lanes of a row group
  static constexpr int RG = 32 / CC;    // row groups of a warp
  static constexpr int BAND = TM * RG;  // rows of a warp
  static constexpr int XTP = BAND + 4;  // a k of the warp's copy, padded
  // floats of a warp's copy: KS k and one more, which the prefetch of the
  // k after the last reads (unused)
  static constexpr int XT = (KS + 1) * XTP;
  // the most threads a CTA launches: its computing warps at MAX_ROWS rows,
  // and the producer warp
  static constexpr int THREADS =
      (MAX_ROWS * CT / (TM * 8) < 256 ? MAX_ROWS * CT / (TM * 8) : 256) +
      32;
  static_assert(CC * RG == 32 && BAND <= MAX_ROWS && THREADS <= MAX_THREADS &&
                    TM % 4 == 0,
                "tile layout");
};

// Element (r, k) of a staged x slab, whose rows are KS elements (128 bytes
// fp32, 64 bf16) laid out as the tensor copies' 128- or 64-byte swizzle
// lays them from a 1024-byte aligned base: the 16-byte chunk k / VK of row
// r sits at chunk (k / VK) ^ (r & 7) (fp32) or ^ (r / 2 & 3) (bf16), so the
// lanes reading one chunk of consecutive rows hit distinct bank groups, and
// a row takes the bytes of its KS elements and no more from memory.
template <typename T>
__device__ inline int xs_at(int r, int k) {
  constexpr int RB = KS * sizeof(T);
  constexpr int MASK = RB == 128 ? 7 : 3;
  const int o = r * RB + k * (int)sizeof(T);
  return (o ^ ((o >> 7 & MASK) << 4)) / (int)sizeof(T);
}

template <typename T>
struct TileArgs {
  const int* pair_ptr;
  const int* ks[2];     // per stream the chunk of each step (-1: dead)
  const int* js;        // the slot of each step
  const T* x;           // [M, K]
  const T* vals[2];     // per stream [nb * max_nz, bk, bn]
  T* out;               // [M, nb * bn]
  int* occ_out;         // [M / sub_m, nb], or null
  int occ_whole;        // 1: every sub_m sub-block of a row block and its
                        // n-block lies in one CTA, which stores its entry;
                        // 0: CTAs OR their parts into a zeroed occ_out
  int M, K, nb, mb, max_nz, bk, bn, bm, sub_m, act;
  int rows;             // rows of a CTA tile (RT)
  int slices, groups;   // CTA tiles per row block, per n-block
  int tma;              // 1: tensor copies into the ring; 0: plain copies
  int vec_out;          // 1: 16-byte output stores (bn * sizeof(T) % 16 == 0)
  // the tap-slab operand: x is the map [B, H, W, cin] (cpt = cin / bk
  // chunks a tap), its images img_stride elements apart (its pixels
  // contiguous), rows are pixels of images of m_pad rows, m_img real
  int H, W, cin, cpt, kw, sh, sw, ph0, pw0, ow, m_img, m_pad;
  long img_stride;
  const T* res;         // tile_kernel_residual: the shortcut [M, nb * bn]
};

// The conv geometry of the tap-slab operand, as the C entry takes it.
struct MapGeom {
  int H, W, cin, kh, kw, sh, sw, ph0, ph1, pw0, pw1, m_pad, img_stride;
};

// cuTensorMapEncodeIm2col, looked up as ffn_grid.cuh looks up the tiled
// encoder (no link against libcuda)
inline PFN_cuTensorMapEncodeIm2col_v12000 encode_im2col_fn() {
  static PFN_cuTensorMapEncodeIm2col_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeIm2col_v12000>(p);
  }
  return fn;
}

// The im2col map of the NHWC input: `pixels` pixels a column of KS
// channels each, the bounding box of the window's top-left positions
// (lower corner -pads, upper corner pads - (window - 1)) walked with the
// conv's strides, in the stage's swizzle.
template <typename T>
inline bool encode_im2col(CUtensorMap* map, const void* x, int B,
                          const MapGeom& g, int pixels) {
  const auto fn = encode_im2col_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.W,
                              (cuuint64_t)g.H, (cuuint64_t)B};
  const cuuint64_t px = (cuuint64_t)g.cin * sizeof(T);
  const cuuint64_t strides[3] = {px, px * g.W,
                                 (cuuint64_t)g.img_stride * sizeof(T)};
  const int lower[2] = {-g.pw0, -g.ph0};
  const int upper[2] = {g.pw1 - (g.kw - 1), g.ph1 - (g.kh - 1)};
  const cuuint32_t estr[4] = {1, (cuuint32_t)g.sw, (cuuint32_t)g.sh, 1};
  return fn(map,
            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(x), dims, strides, lower, upper, KS,
            (cuuint32_t)pixels, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One im2col tensor copy: the pixels from (w, h) of image n on, channels
// from c, each shifted by the window offset (dx, dy).
__device__ inline void tma_im2col(void* dst, const CUtensorMap* map, int c,
                                  int w, int h, int n, int dx, int dy,
                                  unsigned long long* bar) {
  const unsigned short ox = static_cast<unsigned short>(dx);
  const unsigned short oy = static_cast<unsigned short>(dy);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(fgrid::smem_addr(dst)),
      "l"(map), "r"(fgrid::smem_addr(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(ox), "h"(oy)
      : "memory");
}

template <typename T>
__device__ inline T zero_of();
template <>
__device__ inline float zero_of<float>() { return 0.f; }
template <>
__device__ inline __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// The warp's band of a staged x (xb: its first row, xs_at apart) widened and
// transposed into the warp's fp32 copy xt[k][row], its first kn k; returns
// whether any of them is non-zero (-0 is zero), the warp's vote: every lane
// must call it. MAP: rows from vrows on are not pixels of the image and
// read as zeros.
template <typename T, int TM, int CT, bool MAP>
__device__ inline bool stage_band(const T* xb, float* xt, int kn, int lane,
                                  int vrows) {
  using L = Lay<T, TM, CT>;
  using V = V16<T>;
  unsigned nz = 0;
  if (kn == KS) {
    constexpr int VR = KS / L::VK;  // 16-byte vectors of a row
    static_assert(L::BAND * VR % 32 == 0, "whole rounds of the warp");
#pragma unroll
    for (int it = 0; it < L::BAND * VR / 32; ++it) {
      const int u = it * 32 + lane;
      const int r = u % L::BAND, kq = u / L::BAND;
      typename V::R v = ld16(xb + xs_at<T>(r, kq * L::VK));
      if constexpr (MAP) {
        if (r >= vrows) v = typename V::R{};
      }
      const uint4 bits = *reinterpret_cast<const uint4*>(&v);
      nz |= bits.x | bits.y | bits.z | bits.w;
#pragma unroll
      for (int q = 0; q < L::VK; ++q)
        xt[(kq * L::VK + q) * L::XTP + r] = V::at(v, q);
    }
    nz &= V::MAG;
  } else {
    for (int u = lane; u < L::BAND * kn; u += 32) {
      const int r = u % L::BAND, k = u / L::BAND;
      const float v =
          MAP && r >= vrows ? 0.f : tile::widen(xb[xs_at<T>(r, k)]);
      xt[k * L::XTP + r] = v;
      nz |= v != 0.f;
    }
  }
  return __any_sync(0xffffffffu, nz != 0);
}

// acc[i][c] += xt[k][row i] * w[k][column c] for the first kn k, k
// ascending. xt: the warp's copy at the thread's first row; w: the stage's
// weight rows [KS][CT] at the thread's first column. Each k's operands are
// loaded during the k before (the k after the last reads the copy's spare
// k and the shared memory past the stage, unused).
template <typename T, int TM, int CT>
__device__ __forceinline__ void mac(float (&acc)[TM][8], const float* xt,
                                   const T* w, int kn) {
  using L = Lay<T, TM, CT>;
  using V = V16<T>;
  float4 a[2][TM / 4];
  typename V::R b[2][L::NV];
  auto load = [&](int s, int k) {
#pragma unroll
    for (int i = 0; i < TM / 4; ++i)
      a[s][i] = *reinterpret_cast<const float4*>(xt + k * L::XTP + 4 * i);
#pragma unroll
    for (int v = 0; v < L::NV; ++v)
      b[s][v] = ld16(w + k * CT + v * (CT / L::NV));
  };
  auto step = [&](int s) {
    float bw[8];
#pragma unroll
    for (int v = 0; v < L::NV; ++v)
#pragma unroll
      for (int c = 0; c < L::VK; ++c) bw[v * L::VK + c] = V::at(b[s][v], c);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float x = V16<float>::at(a[s][i / 4], i % 4);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(x, bw[c], acc[i][c]);
    }
  };
  load(0, 0);
  int k = 0;
#pragma unroll(TM == 8 ? 2 : 1)
  for (; k + 2 <= kn; k += 2) {
    load(1, k + 1);
    step(0);
    load(0, k + 2);
    step(1);
  }
  if (k < kn) step(0);
}

// One CTA: RT = a.rows rows x CT columns of one pair's output. MAP: x is
// the input map (the tap-slab operand). RES: the flush adds a.res before
// act. tx, tw0 and tw1 are the kernel's own __grid_constant__ parameters.
template <typename T, int TM, int CT, bool GATED, bool MAP, bool RES>
__device__ __forceinline__ void tile_body(const TileArgs<T>& a,
                                          const CUtensorMap& tx,
                                          const CUtensorMap& tw0,
                                          const CUtensorMap& tw1) {
  using L = Lay<T, TM, CT>;
  using V = V16<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  __shared__ __align__(8) unsigned long long empty[STAGES];
  __shared__ int s_len;
  __shared__ int row_nz[MAX_ROWS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // with tensor copies one more warp, the last, only issues them
  const int consumers = a.rows / L::BAND * 32;
  const bool producer = a.tma && tid >= consumers;
  // row block outermost: the CTAs of one row block's x run together
  int b = blockIdx.x;
  const int cg = b % a.groups;
  b /= a.groups;
  const int sl = b % a.slices;
  b /= a.slices;
  const int n = b % a.nb, m = b / a.nb;
  const int p = n * a.mb + m;
  const int r0 = sl * a.rows;
  const long row_base = (long)m * a.bm + r0;
  const int rows = min(a.rows, a.bm - r0);  // rows stored
  const int c0 = cg * CT, cols = min(CT, a.bn - c0);
  const int stage = a.rows * KS + KS * CT;  // elements of a stage
  // MAP: the tile lies in image img from its pixel p0 on, and holds vlim
  // real pixels (all its rows when more); the copies start at the window
  // position (w0, h0) of pixel p0
  int img = 0, p0 = 0, vlim = MAX_ROWS, w0 = 0, h0 = 0;
  if constexpr (MAP) {
    img = static_cast<int>(row_base / a.m_pad);
    p0 = static_cast<int>(row_base - (long)img * a.m_pad);
    vlim = a.m_img - p0;
    const int oy0 = p0 / a.ow;
    w0 = (p0 - oy0 * a.ow) * a.sw - a.pw0;
    h0 = oy0 * a.sh - a.ph0;
  }
  // 1024-byte aligned for the swizzled tensor copies, by pointer arithmetic
  // on the shared array so that the compiler keeps shared (not generic)
  // loads
  T* ring =
      reinterpret_cast<T*>(smem_raw + (-fgrid::smem_addr(smem_raw) & 1023u));
  int2* list = reinterpret_cast<int2*>(ring + (a.tma ? STAGES : 1) * stage);
  // the warps' fp32 copies of their bands, after the list
  float* xts = reinterpret_cast<float*>(list + 2 * max(a.max_nz, 1));

  // The items in schedule order, per step stream 0 then stream 1 where it
  // is live: {chunk, 2 j + stream}.
  if (warp == 0) {
    const int beg = a.pair_ptr[p], end = a.pair_ptr[p + 1];
    const unsigned below = (1u << lane) - 1;
    int len = 0;
    for (int t0 = beg; t0 < end; t0 += 32) {
      const int t = t0 + lane;
      const int k0 = t < end ? a.ks[0][t] : -1;
      const int k1 = GATED && t < end ? a.ks[1][t] : -1;
      const unsigned b0 = __ballot_sync(0xffffffffu, k0 >= 0);
      const unsigned b1 = __ballot_sync(0xffffffffu, k1 >= 0);
      int pos = len + __popc(b0 & below) + __popc(b1 & below);
      if (k0 >= 0 || k1 >= 0) {
        const int j = a.js[t];
        if (k0 >= 0) list[pos++] = make_int2(k0, 2 * j);
        if (k1 >= 0) list[pos] = make_int2(k1, 2 * j + 1);
      }
      len += __popc(b0) + __popc(b1);
    }
    if (lane == 0) {
      s_len = len;
      if (a.tma) {
        for (int s = 0; s < STAGES; ++s) {
          fgrid::mbar_init(&full[s]);
          mbar_init_count(&empty[s], consumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
    }
  }
  __syncthreads();
  const int nsl = (a.bk + KS - 1) / KS;  // stages of a chunk
  // a tile of pad rows only walks nothing: its rows flush act(0)
  const int total = MAP && vlim <= 0 ? 0 : s_len * nsl;
  const unsigned stage_bytes = stage * static_cast<unsigned>(sizeof(T));

  // the producer starts stage e's tensor copies into ring slot e % STAGES
  auto load = [&](int e) {
    const int2 it = list[e / nsl];
    const int k0 = e % nsl * KS, s = e % STAGES;
    T* st = ring + s * stage;
    fgrid::mbar_expect(&full[s], stage_bytes);
    if constexpr (MAP) {
      const int tap = it.x / a.cpt, dy = tap / a.kw;
      tma_im2col(st, &tx, (it.x - tap * a.cpt) * a.bk + k0, w0, h0, img,
                 tap - dy * a.kw, dy, &full[s]);
    } else {
      fgrid::tma2(st, &tx, it.x * a.bk + k0, (int)row_base, &full[s]);
    }
    fgrid::tma3(st + a.rows * KS, (it.y & 1) ? &tw1 : &tw0, c0, k0,
                n * a.max_nz + (it.y >> 1), &full[s]);
  };
  // without tensor copies every thread copies its share of stage e into
  // slot 0 (zeros past M, K, bk and bn, as the tensor copies give)
  auto copy = [&](int e) {
    const int2 it = list[e / nsl];
    const int k0 = e % nsl * KS;
    if constexpr (MAP) {
      // the im2col copy's address map: pixel p0 + r, shifted by the tap
      const int tap = it.x / a.cpt, dy = tap / a.kw, dx = tap - dy * a.kw;
      const int ch = (it.x - tap * a.cpt) * a.bk + k0;
      for (int u = tid; u < a.rows * KS; u += blockDim.x) {
        const int r = u / KS, c = u % KS;
        T v = zero_of<T>();
        if (r < vlim && ch + c < a.cin) {
          const int oy = (p0 + r) / a.ow, ox = p0 + r - oy * a.ow;
          const int iy = oy * a.sh + dy - a.ph0, ix = ox * a.sw + dx - a.pw0;
          if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
            v = a.x[img * a.img_stride + ((long)iy * a.W + ix) * a.cin +
                    ch + c];
        }
        ring[xs_at<T>(r, c)] = v;
      }
    } else {
      const long xc = (long)it.x * a.bk + k0;
      for (int u = tid; u < a.rows * KS; u += blockDim.x) {
        const int r = u / KS, c = u % KS;
        ring[xs_at<T>(r, c)] = row_base + r < a.M && xc + c < a.K
                                   ? a.x[(row_base + r) * a.K + xc + c]
                                   : zero_of<T>();
      }
    }
    const T* w =
        a.vals[it.y & 1] + ((long)n * a.max_nz + (it.y >> 1)) * a.bk * a.bn;
    T* ws = ring + a.rows * KS;
    for (int u = tid; u < KS * CT; u += blockDim.x) {
      const int r = u / CT, c = u % CT;
      ws[u] = k0 + r < a.bk && c0 + c < a.bn
                  ? w[(long)(k0 + r) * a.bn + c0 + c]
                  : zero_of<T>();
    }
  };

  float acc[TM][8], acc2[GATED ? TM : 1][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[i][c] = 0.f;
      if constexpr (GATED) acc2[i][c] = 0.f;
    }
  const int g = lane / L::CC, cl = lane % L::CC;
  const int band0 = warp * L::BAND;
  float* xt = xts + warp * L::XT;               // the warp's copy
  const int wo = a.rows * KS + cl * L::VK;  // the thread's first column
  const int bo = band0 * KS;                // the warp's band
  const int vrows = vlim - band0;           // MAP: real rows of the band

  // one stage: the warp skips it when its band of x is all zero there
  auto consume = [&](int e, const T* st) {
    const int kn = min(KS, a.bk - e % nsl * KS);
    __syncwarp();  // the warp is done with its copy of e - 1
    const bool live =
        stage_band<T, TM, CT, MAP>(st + bo, xt, kn, lane, vrows);
    __syncwarp();
    if (!live) return;
    if constexpr (GATED) {
      if (list[e / nsl].y & 1) {
        mac<T, TM, CT>(acc2, xt + TM * g, st + wo, kn);
        return;
      }
    }
    mac<T, TM, CT>(acc, xt + TM * g, st + wo, kn);
  };
  if (producer) {
    // refill a slot once every consumer thread has released it, so that
    // the warps drift apart and one's stage start hides behind another's
    // FMAs
    if (lane == 0)
      for (int e = 0; e < total; ++e) {
        const int s = e % STAGES;
        if (e >= STAGES) fgrid::mbar_wait(&empty[s], (e / STAGES - 1) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(e);
      }
    __syncwarp();
  } else if (a.tma) {
    for (int e = 0; e < total; ++e) {
      const int s = e % STAGES;
      fgrid::mbar_wait(&full[s], (e / STAGES) & 1);  // stage e has landed
      consume(e, ring + s * stage);
      mbar_arrive(&empty[s]);
    }
  } else {
    for (int e = 0; e < total; ++e) {
      __syncthreads();  // every thread is done with e - 1
      copy(e);
      __syncthreads();
      consume(e, ring);
    }
  }

  // the flush: act, one rounding, 16-byte stores where bn allows
  const long ldo = (long)a.nb * a.bn;
  T* out = a.out + row_base * ldo + (long)n * a.bn + c0;
  unsigned nz = 0;  // bit i: the thread stored a non-zero to its row i
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = band0 + TM * g + i;
    if (producer || r >= rows) continue;
#pragma unroll
    for (int v = 0; v < L::NV; ++v) {
      const int col = cl * L::VK + v * (CT / L::NV);
      float y[L::VK];
      // RES: the shortcut at the elements this thread stores
      float sc[L::VK];
      if constexpr (RES) {
        const T* rp = a.res + (row_base + r) * ldo + (long)n * a.bn + c0 + col;
        if (a.vec_out && col + L::VK <= cols) {
          const typename V::R rv = ld16(rp);
#pragma unroll
          for (int c = 0; c < L::VK; ++c) sc[c] = V::at(rv, c);
        } else {
#pragma unroll
          for (int c = 0; c < L::VK; ++c)
            sc[c] = col + c < cols ? tile::widen(rp[c]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < L::VK; ++c) {
        float gv = 0.f;
        if constexpr (GATED) gv = acc2[i][v * L::VK + c];
        float h = acc[i][v * L::VK + c];
        if constexpr (RES) h += sc[c];
        y[c] = fgrid::act_of(h, gv, a.act);
        if (a.occ_out != nullptr && col + c < cols &&
            fgrid::stored_nonzero(y[c], out))
          nz |= 1u << i;
      }
      T* o = out + r * ldo + col;
      if (a.vec_out && col + L::VK <= cols) {
        *reinterpret_cast<typename V::R*>(o) = V::pack(y);
      } else {
#pragma unroll
        for (int c = 0; c < L::VK; ++c)
          if (col + c < cols) tile::store(o + c, y[c]);
      }
    }
  }
  if (a.occ_out == nullptr) return;
  if (a.occ_whole && L::BAND % a.sub_m == 0 && a.sub_m % TM == 0) {
    // every sub_m sub-block lies in one warp's band, every thread's rows in
    // one sub-block: one ballot, and the sub-block's first lane stores it
    if (producer) return;
    const unsigned live = __ballot_sync(0xffffffffu, nz != 0);
    const int per = a.sub_m / TM * L::CC;  // consecutive lanes of a sub-block
    const int r = band0 + TM * g;
    if (lane % per == 0 && r < rows) {
      const unsigned mine = per == 32 ? ~0u : ((1u << per) - 1) << lane;
      a.occ_out[(row_base + r) / a.sub_m * a.nb + n] = (live & mine) != 0;
    }
    return;
  }
  // otherwise the rows' bits ORed over the column lanes, then per sub_m
  // sub-block (or its part in this CTA) a store, or an atomic OR where
  // other CTAs hold parts of it
#pragma unroll
  for (int d = L::CC / 2; d > 0; d >>= 1)
    nz |= __shfl_xor_sync(0xffffffffu, nz, d);
  if (cl == 0 && !producer)
#pragma unroll
    for (int i = 0; i < TM; ++i) row_nz[band0 + TM * g + i] = nz >> i & 1;
  __syncthreads();
  for (int r = tid; r < rows; r += blockDim.x) {
    const long row = row_base + r;
    if (r > 0 && row % a.sub_m) continue;  // not the first row of its part
    int any = 0;
    for (int q = r; q < rows && (q == r || (row_base + q) % a.sub_m); ++q)
      any |= row_nz[q];
    int* o = a.occ_out + row / a.sub_m * a.nb + n;
    if (a.occ_whole)
      *o = any;
    else if (any)
      atomicOr(o, 1);
  }
}

template <typename T, int TM, int CT, bool GATED, bool MAP>
__global__ void __launch_bounds__((Lay<T, TM, CT>::THREADS))
    tile_kernel(const TileArgs<T> a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw0,
                const __grid_constant__ CUtensorMap tw1) {
  tile_body<T, TM, CT, GATED, MAP, false>(a, tx, tw0, tw1);
}

// tile_kernel whose flush stores act(acc + a.res): one stream, the patch
// matrix
template <typename T, int TM, int CT>
__global__ void __launch_bounds__((Lay<T, TM, CT>::THREADS))
    tile_kernel_residual(const TileArgs<T> a,
                         const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw0,
                         const __grid_constant__ CUtensorMap tw1) {
  tile_body<T, TM, CT, false, false, true>(a, tx, tw0, tw1);
}

template <typename T, int TM, int CT, bool GATED, bool MAP, bool RES>
int launch_tile_ct(TileArgs<T> a, const MapGeom& g, cudaStream_t st) {
  using L = Lay<T, TM, CT>;
  const auto kernel = [] {
    if constexpr (RES)
      return tile_kernel_residual<T, TM, CT>;
    else
      return tile_kernel<T, TM, CT, GATED, MAP>;
  }();
  const int threads = a.rows * CT / (TM * 8) + (a.tma ? 32 : 0);
  if (a.rows <= 0 || a.rows > MAX_ROWS || a.rows % L::BAND ||
      threads > L::THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx{}, tw[2]{};
  if (a.tma) {
    const cuuint64_t xd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
    const cuuint32_t xb[2] = {(cuuint32_t)KS, (cuuint32_t)a.rows};
    if (MAP ? !encode_im2col<T>(&tx, a.x, a.M / a.m_pad, g, a.rows)
            : !fgrid::encode<T>(&tx, a.x, 2, xd, xb,
                                sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B))
      return static_cast<int>(cudaErrorInvalidValue);
    tw[0] = tw[1] = tx;  // no weights to map when max_nz == 0
    if (a.max_nz > 0) {
      const cuuint64_t wd[3] = {(cuuint64_t)a.bn, (cuuint64_t)a.bk,
                                (cuuint64_t)a.nb * a.max_nz};
      const cuuint32_t wb[3] = {CT, KS, 1};
      for (int s = 0; s < (GATED ? 2 : 1); ++s)
        if (!fgrid::encode<T>(&tw[s], a.vals[s], 3, wd, wb))
          return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t smem =
      1024 +
      (size_t)(a.tma ? STAGES : 1) * (a.rows * KS + KS * CT) *
          sizeof(T) +
      2 * (size_t)max(a.max_nz, 1) * sizeof(int2) +
      (size_t)a.rows / L::BAND * L::XT * sizeof(float);
  // the 48 KB a block gets without asking counts its static shared memory
  // (under 1 KB) too
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks = (long)a.mb * a.nb * a.slices * a.groups;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, threads, smem, st>>>(a, tx, tw[0], tw[1]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TM, bool GATED, bool MAP, bool RES = false>
int launch_tile_tm(const TileArgs<T>& a, const MapGeom& g, int cols,
                   cudaStream_t st) {
  switch (cols) {
    case 128:
      return launch_tile_ct<T, TM, 128, GATED, MAP, RES>(a, g, st);
    case 64:
      return launch_tile_ct<T, TM, 64, GATED, MAP, RES>(a, g, st);
    case 32:
      return launch_tile_ct<T, TM, 32, GATED, MAP, RES>(a, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tile mode: CTAs of rows x cols with thread_rows rows a thread (8, or
// 4; two streams take 4), a ring of tensor copies (tma = 1) or plain copies
// (tma = 0); with g.m_pad > 0 x is the input map (the tap-slab operand);
// with res the residual flush (fp32, one stream, the patch matrix).
template <typename T>
int launch_tile(const void* x, const void* vals, const void* vals2,
                const int* pair_ptr, const int* ks, const int* k2s,
                const int* js, void* out, int* occ_out, int M, int K, int nb,
                int mb, int max_nz, int bk, int bn, int bm_rows, int sub_m,
                int act, int emit_occ, int rows, int cols, int thread_rows,
                int tma, const MapGeom& g, const void* res, cudaStream_t st) {
  TileArgs<T> a{};
  a.res = static_cast<const T*>(res);
  a.pair_ptr = pair_ptr;
  a.ks[0] = ks, a.ks[1] = k2s;
  a.js = js;
  a.x = static_cast<const T*>(x);
  a.vals[0] = static_cast<const T*>(vals);
  a.vals[1] = static_cast<const T*>(vals2 ? vals2 : vals);
  a.out = static_cast<T*>(out);
  a.occ_out = emit_occ ? occ_out : nullptr;
  a.M = M, a.K = K, a.nb = nb, a.mb = mb, a.max_nz = max_nz, a.bk = bk;
  a.bn = bn, a.bm = bm_rows, a.sub_m = sub_m, a.act = act;
  a.rows = rows;
  a.slices = rows > 0 ? (bm_rows + rows - 1) / rows : 0;
  a.groups = (bn + cols - 1) / cols;
  a.tma = tma;
  a.vec_out = bn * sizeof(T) % 16 == 0;
  if (bm_rows <= 0 || M != mb * bm_rows || bk <= 0 || K % bk || bn <= 0 ||
      bn > 128 || sub_m <= 0 || bm_rows % sub_m || max_nz < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool map = g.m_pad > 0;
  if (map) {
    const int oh = (g.H + g.ph0 + g.ph1 - g.kh) / g.sh + 1;
    a.ow = (g.W + g.pw0 + g.pw1 - g.kw) / g.sw + 1;
    a.H = g.H, a.W = g.W, a.cin = g.cin, a.cpt = g.cin / bk, a.kw = g.kw;
    a.sh = g.sh, a.sw = g.sw, a.ph0 = g.ph0, a.pw0 = g.pw0;
    a.m_img = oh * a.ow, a.m_pad = g.m_pad, a.img_stride = g.img_stride;
    // one stream; images of whole row blocks; every chunk a (tap, channel
    // group) of the map
    if (vals2 != nullptr || g.cin % bk || g.sh <= 0 || g.sw <= 0 ||
        oh <= 0 || a.ow <= 0 || g.m_pad < a.m_img || g.m_pad % bm_rows ||
        M % g.m_pad || K != g.kh * g.kw * g.cin ||
        g.img_stride < (long)g.H * g.W * g.cin)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // tiles of whole sub-blocks and whole n-blocks store the occupancy, no
  // memset before the launch and no atomics
  a.occ_whole = rows > 0 && rows % sub_m == 0 && a.groups == 1;
  if (a.occ_out != nullptr && !a.occ_whole) {
    const cudaError_t e = cudaMemsetAsync(
        a.occ_out, 0, sizeof(int) * (size_t)(M / sub_m) * nb, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (res != nullptr) {
    if constexpr (std::is_same<T, float>::value) {
      if (vals2 != nullptr || map)
        return static_cast<int>(cudaErrorInvalidValue);
      if (thread_rows == 8)
        return launch_tile_tm<T, 8, false, false, true>(a, g, cols, st);
      if (thread_rows == 4)
        return launch_tile_tm<T, 4, false, false, true>(a, g, cols, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vals2 != nullptr)
    return thread_rows == 4 ? launch_tile_tm<T, 4, true, false>(a, g, cols, st)
                            : static_cast<int>(cudaErrorInvalidValue);
  if (thread_rows == 8)
    return map ? launch_tile_tm<T, 8, false, true>(a, g, cols, st)
               : launch_tile_tm<T, 8, false, false>(a, g, cols, st);
  if (thread_rows == 4)
    return map ? launch_tile_tm<T, 4, false, true>(a, g, cols, st)
               : launch_tile_tm<T, 4, false, false>(a, g, cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
// grid mode (bm_rows dividing 32); col_group 0 the tile mode, with CTA tiles
// of tile_rows x tile_cols, thread_rows rows a thread, a ring of tensor
// copies when tma == 1 or plain copies when tma == 0. m_pad > 0 (the tile
// mode, one stream): x is the NHWC input map [M / m_pad, H, W, cin] of a
// kh x kw conv with strides (sh, sw) and pads (ph0, ph1), (pw0, pw1), its
// images img_stride elements apart (each image's pixels contiguous), whose
// outputs take m_pad rows an image, and K = kh * kw * cin (the tap-slab
// operand); m_pad == 0: x is the patch matrix [M, K]. res, or null: the
// shortcut [M, nb * bn] that the tile mode's flush adds before act (fp32,
// one stream, the patch matrix).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int walk_spmm(const void* x, const void* vals, const void* vals2,
                         const int* pair_ptr, const int* ks, const int* k2s,
                         const int* js, void* out, int* occ_out, int M, int K,
                         int nb, int mb, int max_nz, int bk, int bn,
                         int bm_rows, int sub_m, int act, int emit_occ,
                         int ncolors, int mb_per_img, int bf16,
                         int col_group, int tile_rows, int tile_cols,
                         int thread_rows, int tma, int H, int W, int cin,
                         int kh, int kw, int sh, int sw, int ph0, int ph1,
                         int pw0, int pw1, int m_pad, int img_stride,
                         const void* res, void* stream) {
  (void)ncolors;     // see the note on colouring above
  (void)mb_per_img;
  if ((vals2 == nullptr) != (k2s == nullptr) || act < tile::ACT_NONE ||
      act > tile::ACT_GEGLU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MapGeom g{H, W, cin, kh, kw, sh, sw, ph0, ph1, pw0, pw1, m_pad,
                  img_stride};
  if (col_group != 0) {
    if (m_pad != 0 || res != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
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
    return launch_tile<__nv_bfloat16>(
        x, vals, vals2, pair_ptr, ks, k2s, js, out, occ_out, M, K, nb, mb,
        max_nz, bk, bn, bm_rows, sub_m, act, emit_occ, tile_rows, tile_cols,
        thread_rows, tma, g, res, st);
  return launch_tile<float>(x, vals, vals2, pair_ptr, ks, k2s, js, out,
                            occ_out, M, K, nb, mb, max_nz, bk, bn, bm_rows,
                            sub_m, act, emit_occ, tile_rows, tile_cols,
                            thread_rows, tma, g, res, st);
}
