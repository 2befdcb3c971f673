// The tile core shared by the walker (walk.cu) and the dense grid
// (conv_grid.cu): one CUDA block owns a 64-row slice of one (n, m) output
// tile and accumulates it in registers.
//
// Staging. x and w are staged in shared memory in 32-deep k-slabs
// (64x32 + 32x128 floats = 24 KB, under the 48 KB static limit); 256
// threads each hold a 4-row x TN-column register tile (TN = 4 for bn <= 64,
// 8 for bn <= 128), columns strided by 16 so shared reads and global stores
// are conflict-free and coalesced.
//
// Sum order. mac_chunk adds one chunk in ascending k with one fmaf per term,
// and both kernels call it once per chunk in ascending j. The fp32 sum order
// of every output element is therefore fixed here, in one place, and the two
// kernels give bit for bit the same output on the same schedule. (A row the
// dense grid predicates off would add fmaf(0, w, acc) == acc in the walker.)
#pragma once
#include <cuda_runtime.h>

namespace tile {

constexpr int RS = 64;        // rows per block: one slice of a row block
constexpr int KS = 32;        // k-slab depth staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads

template <int TN>
struct Smem {
  float xs[KS][RS + 1];  // transposed x slab, padded: no bank conflicts
  float ws[KS][16 * TN];
  int row_nz[RS];        // per-row "some output != 0" for the occupancy
};

// Where this block's slice lies, and this thread's place in it.
struct Slice {
  int tid, tx, ty;  // thread, its column lane (0..15) and row group (0..15)
  int rows;         // valid rows of the slice (< RS only at a short block)
  long row_base;    // first row of the slice in x and out
};

__device__ inline Slice slice_of(int m, int bm_rows) {
  Slice s;
  s.tid = threadIdx.x;
  s.tx = s.tid % 16;
  s.ty = s.tid / 16;
  const int r0 = blockIdx.y * RS;
  s.rows = min(RS, bm_rows - r0);
  s.row_base = (long)m * bm_rows + r0;
  return s;
}

template <int TN>
__device__ inline void zero(float (&acc)[4][TN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
}

// acc += x[slice rows, bk-chunk at xb] @ w[bk, bn at wb]. With PRED, row i
// of this thread's 4 takes no term where lv[i] is false (the sub_m skip).
// Every thread of the block must call it: it holds block barriers.
template <int TN, bool PRED>
__device__ inline void mac_chunk(float (&acc)[4][TN], Smem<TN>& sm,
                                 const Slice& s, const float* xb,
                                 const float* wb, int K, int bk, int bn,
                                 const bool (&lv)[4]) {
  constexpr int BN = 16 * TN;
  for (int k0 = 0; k0 < bk; k0 += KS) {
    for (int i = s.tid; i < RS * KS; i += THREADS) {
      const int r = i / KS, c = i % KS;
      sm.xs[c][r] =
          (r < s.rows && k0 + c < bk) ? xb[(long)r * K + k0 + c] : 0.f;
    }
    for (int i = s.tid; i < KS * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      sm.ws[r][c] =
          (k0 + r < bk && c < bn) ? wb[(long)(k0 + r) * bn + c] : 0.f;
    }
    __syncthreads();
    const int kn = min(KS, bk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.xs[kk][s.ty * 4 + i];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = sm.ws[kk][s.tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (PRED && !lv[i]) continue;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
    }
    __syncthreads();
  }
}

// Epilogue: ReLU or nothing, write block column n of the slice into out
// [M, nb*bn] and, with emit_occ, occ_out[row / sub_m, n] = any output of
// those sub_m rows != 0. Every thread of the block must call it.
template <int TN>
__device__ inline void flush(const float (&acc)[4][TN], Smem<TN>& sm,
                             const Slice& s, float* out, int* occ_out, int n,
                             int nb, int bn, int sub_m, int relu,
                             int emit_occ) {
  if (emit_occ) {
    if (s.tid < RS) sm.row_nz[s.tid] = 0;
    __syncthreads();
  }
  const long ldo = (long)nb * bn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = s.ty * 4 + i;
    int nz = 0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = s.tx + 16 * c;
      float v = acc[i][c];
      if (relu) v = fmaxf(v, 0.f);
      if (r < s.rows && col < bn) {
        out[(s.row_base + r) * ldo + (long)n * bn + col] = v;
        nz |= (v != 0.f);
      }
    }
    if (emit_occ && nz) atomicOr(&sm.row_nz[r], 1);
  }
  if (emit_occ) {
    __syncthreads();
    if (s.tid < s.rows / sub_m) {
      int any = 0;
      for (int q = 0; q < sub_m; ++q) any |= sm.row_nz[s.tid * sub_m + q];
      occ_out[(s.row_base / sub_m + s.tid) * nb + n] = any;
    }
  }
}

}  // namespace tile
