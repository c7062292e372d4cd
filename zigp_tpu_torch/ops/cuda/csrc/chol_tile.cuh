// The blocked, register-tiled Cholesky shared by chol.cu (L) and
// chol_inv.cu (L and L^-1): one CTA factors one small SPD float32 matrix.
//
// The matrix is walked in block steps of NB columns [j0, j1), j1 =
// min(j0 + NB, n); only the last block can be ragged (no padding of n).
// Block 0's diagonal is factored before the loop; then a step is:
//
//   P. Each thread with a work item reads L_jj and its pivots' reciprocals
//      from shared memory into registers (broadcast loads). A row i >= j1 of
//      the panel is forward-substituted against L_jj: x = A[i][j0:j1]
//      L_jj^-T, each column first absorbing the earlier columns of the
//      step, then scaled by its pivot -- the operations, in the same order,
//      of the plain chol_plain(K, rank=NB) (ops/cuda/cholesky.py), except
//      that the kernel multiplies by the IEEE reciprocal of the pivot where
//      the plain version divides (an IEEE division costs about 100 cycles on
//      the chain, its slow-path branch keeping the next one from overlapping
//      it), so the two agree to rounding. No product with an explicit
//      L_jj^-1: that errs by cond(L_jj) eps. With kInv, a column c < j1 of
//      block row j of B = L^-1 (which holds I - sum_{k<j} L_jk B_k by then)
//      is forward-substituted against L_jj in the same way. A barrier.
//   U. The trailing lower triangle A[j1:, j1:] -= L21 L21^T and, with kInv,
//      the rows of B below the block, B[j1:, :j1] -= L21 B[j0:j1, :j1], in
//      4 x 4 micro-tiles: a thread keeps 16 sums in registers and reads the
//      panel as 16-byte vectors, 2 vector loads per 16 FMAs. Each entry
//      takes the step's columns in order, as the plain versions do.
//   D. With lookahead: warp 0 takes the tiles of the next diagonal block
//      first, then factors that block (every lane the same arithmetic in
//      its registers, so nothing is broadcast within the warp) and stores
//      L_jj and the reciprocals, while the other 15 warps do the rest of U.
//      A barrier ends the step. Rows past r of a ragged block are an
//      identity that never reaches the real rows.
//
// So a step costs two __syncthreads(), 26 at n = 100 with NB = 8, where the
// one-column form cost two per column, and the diagonal factor -- a chain of
// one IEEE sqrtf and one IEEE reciprocal a column, which nothing can
// parallelise -- overlaps the trailing update instead of preceding it.
// Measured by experiments/chol_phases.py on an H100 at NB = 8, warp 0's
// lookahead is the longer side at n = 100 and 200 (about 60 % of the
// cycles): the other warps finish their tiles and wait.
// NB is a template parameter (4, 8 or 16): a wider block means fewer
// barriers but a longer chain on warp 0 and more registers for L_jj in
// every thread (at 16 the kernels spill).
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and reciprocal (no
// --use_fast_math), no pivot clamp: a non-PSD input gives NaN from the
// failing pivot on, the rows before it as they were.
//
// Storage is abstracted by Mat. Packed is the lower triangle in shared
// memory, row-major with each row padded to a multiple of 4 floats, so that
// every row starts on a 16-byte boundary and a panel or tile row is read as
// float4s (padded_floats(n) = n(n+1)/2 + at most 5n/2 floats). The padding
// of A holds scratch; that of B = L^-1 holds zeros, which the L^-1 update
// reads as the zeros above B's diagonal. Square is a row-major n x n matrix
// in global memory (the in-place instance of chol.cu above its shared-memory
// limit), whose upper triangle holds scratch until the caller zeroes it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zigp {

constexpr int kTileThreads = 512;
constexpr int kMT = 4;     // edge of a trailing-update micro-tile, and the float4 width
constexpr int kMaxNB = 16;  // the widest block the kernels are built for

// Offset of row i = 4t + s of a lower triangle whose row r is padded to
// ceil4(r + 1) floats, with one float4 of skew before each group of 4 rows:
// 4 sum_{m=1..i} ceil(m / 4) + 4t = 4 ((t + 1)(2t + s) + t). Without the
// skew, group t would start at 2t(t + 1) float4s, only ever 0 or 4 mod 8, and
// a warp reading a float4 from each of several row groups would hit 2 of the
// 8 groups of 4 banks; with it, 8 consecutive groups start on 8 different
// ones.
__host__ __device__ __forceinline__ int padded_row(int i) {
  const int t = i >> 2, s = i & 3;
  return 4 * ((t + 1) * (2 * t + s) + t);
}

__host__ __device__ inline size_t padded_floats(int n) { return static_cast<size_t>(padded_row(n)); }

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float at(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

struct Packed {
  float* p;
  __device__ __forceinline__ float& operator()(int i, int k) const { return p[padded_row(i) + k]; }
  // (i, k..k+3), k % 4 == 0 and k <= i: inside row i's padded length.
  __device__ __forceinline__ float4 load4(int i, int k) const {
    return *reinterpret_cast<const float4*>(p + padded_row(i) + k);
  }
  __device__ __forceinline__ void store4(int i, int k, float4 v) const {
    *reinterpret_cast<float4*>(p + padded_row(i) + k) = v;
  }
};

// Row-major with row stride ld (= n); entries past the row's end are not
// touched.
struct Square {
  float* p;
  int ld;
  __device__ __forceinline__ float& operator()(int i, int k) const { return p[static_cast<size_t>(i) * ld + k]; }
  __device__ __forceinline__ float4 load4(int i, int k) const {
    const float* q = p + static_cast<size_t>(i) * ld + k;
    return make_float4(q[0], k + 1 < ld ? q[1] : 0.0f, k + 2 < ld ? q[2] : 0.0f, k + 3 < ld ? q[3] : 0.0f);
  }
  __device__ __forceinline__ void store4(int i, int k, float4 v) const {
    float* q = p + static_cast<size_t>(i) * ld + k;
    q[0] = v.x;
    if (k + 1 < ld) q[1] = v.y;
    if (k + 2 < ld) q[2] = v.z;
    if (k + 3 < ld) q[3] = v.w;
  }
};

// The lower triangle of the block A[j0:j0+r, j0:j0+r] into l, an identity
// in the rows past r of a ragged block (they never reach the real rows).
template <int NB, class Mat>
__device__ __forceinline__ void load_block(Mat A, int j0, int r, float (&l)[NB][NB]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int k4 = 0; k4 <= i; k4 += kMT) {
      const float4 v = i < r ? A.load4(j0 + i, j0 + k4) : zero4();
#pragma unroll
      for (int e = 0; e < kMT; ++e)
        if (k4 + e <= i) l[i][k4 + e] = i < r ? at(v, e) : (k4 + e == i ? 1.0f : 0.0f);
    }
  }
}

// D, on warp 0: L_jj of A[j0:j1, j0:j1] in every lane's registers (the
// same arithmetic in every lane, so nothing is broadcast), then lane i
// stores row i of L_jj into A and the IEEE reciprocal of pivot i into
// rinv_s.
template <int NB, class Mat>
__device__ __forceinline__ void factor_diag(Mat A, int j0, int r, float* rinv_s) {
  float l[NB][NB], rinv[NB];
  load_block<NB>(A, j0, r, l);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    l[c][c] = sqrtf(l[c][c]);
    rinv[c] = 1.0f / l[c][c];
#pragma unroll
    for (int i = c + 1; i < NB; ++i) l[i][c] = l[i][c] * rinv[c];
#pragma unroll
    for (int i = c + 1; i < NB; ++i)
#pragma unroll
      for (int k = c + 1; k <= i; ++k) l[i][k] = fmaf(-l[i][c], l[k][c], l[i][k]);
  }
  __syncwarp();  // every lane has read the block before any lane overwrites it
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (static_cast<int>(threadIdx.x) == i && i < r) {
#pragma unroll
      for (int k = 0; k <= i; ++k) A(j0 + i, j0 + k) = l[i][k];
      rinv_s[i] = rinv[i];
    }
}

// L_jj and its pivots' reciprocals from shared memory into this thread's
// registers (every thread reads the same addresses: broadcasts).
template <int NB, class Mat>
__device__ __forceinline__ void load_diag(Mat A, int j0, int r, const float* rinv_s, float (&l)[NB][NB],
                                          float (&rinv)[NB]) {
  load_block<NB>(A, j0, r, l);
#pragma unroll
  for (int i = 0; i < NB; ++i) rinv[i] = i < r ? rinv_s[i] : 1.0f;
}

// P: row i >= j1 of the panel, A[i][j0:j1] <- A[i][j0:j1] L_jj^-T (r = NB).
template <int NB, class Mat>
__device__ __forceinline__ void panel_row(Mat A, int i, int j0, const float (&l)[NB][NB], const float (&rinv)[NB]) {
  float x[NB];
#pragma unroll
  for (int k4 = 0; k4 < NB; k4 += kMT) {
    const float4 v = A.load4(i, j0 + k4);
#pragma unroll
    for (int e = 0; e < kMT; ++e) x[k4 + e] = at(v, e);
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    x[c] = x[c] * rinv[c];
#pragma unroll
    for (int k = c + 1; k < NB; ++k) x[k] = fmaf(-x[c], l[k][c], x[k]);
  }
#pragma unroll
  for (int k4 = 0; k4 < NB; k4 += kMT) A.store4(i, j0 + k4, make_float4(x[k4], x[k4 + 1], x[k4 + 2], x[k4 + 3]));
}

// P, with kInv: column col < j1 of block row j of B, B[j0:j1][col] <-
// L_jj^-1 B[j0:j1][col]. Entries above B's diagonal are zero and are neither
// read nor written; they enter the arithmetic as exact zeros.
template <int NB, class Mat>
__device__ __forceinline__ void inv_block_col(Mat B, int col, int j0, int r, const float (&l)[NB][NB],
                                              const float (&rinv)[NB]) {
  float b[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) b[c] = (c < r && col <= j0 + c) ? B(j0 + c, col) : 0.0f;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    b[c] = b[c] * rinv[c];
#pragma unroll
    for (int k = c + 1; k < NB; ++k) b[k] = fmaf(-l[k][c], b[c], b[k]);
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c < r && col <= j0 + c) B(j0 + c, col) = b[c];
}

// acc[a][b] -= sum_c L[i0 + a][j0 + c] Q(c, b) over the step's NB columns
// in order. load_q(k4, q) fills q[0..3] with the four float4s of columns
// j0 + k4 .. j0 + k4 + 3 of Q: with kQRows, q[b] is Q's row b (Q(c, b) =
// q[b][c - k4], the panel rows k0 + b); otherwise q[e] is Q(k4 + e, 0..3)
// (a row of B's block row).
template <int NB, bool kQRows, class Mat, class LoadQ>
__device__ __forceinline__ void tile_update(float (&acc)[kMT][kMT], Mat A, int i0, int n, int j0, LoadQ load_q) {
#pragma unroll
  for (int k4 = 0; k4 < NB; k4 += kMT) {
    float4 li[kMT], q[kMT];
#pragma unroll
    for (int a = 0; a < kMT; ++a) li[a] = i0 + a < n ? A.load4(i0 + a, j0 + k4) : zero4();
    load_q(k4, q);
#pragma unroll
    for (int e = 0; e < kMT; ++e)
#pragma unroll
      for (int a = 0; a < kMT; ++a)
#pragma unroll
        for (int b = 0; b < kMT; ++b)
          acc[a][b] = fmaf(-at(li[a], e), kQRows ? at(q[b], e) : at(q[e], b), acc[a][b]);
  }
}

template <class Mat>
__device__ __forceinline__ void load_tile(float (&acc)[kMT][kMT], Mat X, int i0, int c0, int n) {
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    const float4 v = i0 + a < n ? X.load4(i0 + a, c0) : zero4();
    acc[a][0] = v.x;
    acc[a][1] = v.y;
    acc[a][2] = v.z;
    acc[a][3] = v.w;
  }
}

template <class Mat>
__device__ __forceinline__ void store_tile(const float (&acc)[kMT][kMT], Mat X, int i0, int c0, int n) {
#pragma unroll
  for (int a = 0; a < kMT; ++a)
    if (i0 + a < n) X.store4(i0 + a, c0, make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
}

// The 4 x 4 tiles of a lower triangle T tiles on a side.
__host__ __device__ constexpr int tiles(int T) { return T * (T + 1) / 2; }

// U: the trailing lower triangle and, with kInv, the rows of B below the
// block, one 4 x 4 micro-tile per thread and pass (r = NB, j1 % 4 == 0).
// A diagonal tile also computes the entries above its diagonal, which lie
// in the rows' padding (Packed) or the upper triangle (Square): scratch.
// Tiles are numbered row by row of the trailing triangle, then B's, so the
// first tiles(NB / kMT) of them cover the next diagonal block. This thread
// takes tiles begin + t, begin + t + stride, ... below end.
template <int NB, bool kInv, class Mat>
__device__ __forceinline__ void update_tiles(Mat A, Mat B, int n, int j0, int j1, int begin, int end, int t,
                                             int stride) {
  const int T = (n - j1 + kMT - 1) / kMT;
  const int nA = tiles(T);         // tiles of the trailing lower triangle
  const int Tc = j1 / kMT;         // tile columns of B's rows below the block
  for (int p = begin + t; p < end; p += stride) {
    float acc[kMT][kMT];
    if (p < nA) {
      int ti = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > p) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
      const int i0 = j1 + kMT * ti;
      const int k0 = j1 + kMT * (p - ti * (ti + 1) / 2);
      load_tile(acc, A, i0, k0, n);
      tile_update<NB, true>(acc, A, i0, n, j0, [&](int k4, float4(&q)[kMT]) {  // the panel's rows k0..k0+3
#pragma unroll
        for (int b = 0; b < kMT; ++b) q[b] = k0 + b < n ? A.load4(k0 + b, j0 + k4) : zero4();
      });
      store_tile(acc, A, i0, k0, n);
    } else if constexpr (kInv) {
      const int q = p - nA;
      const int ti = q / Tc;
      const int i0 = j1 + kMT * ti;
      const int c0 = kMT * (q - ti * Tc);
      load_tile(acc, B, i0, c0, n);
      tile_update<NB, false>(acc, A, i0, n, j0, [&](int k4, float4(&q)[kMT]) {  // B[j0 + k4 + e][c0:c0+4]
#pragma unroll
        for (int e = 0; e < kMT; ++e) q[e] = c0 <= j0 + k4 + e ? B.load4(j0 + k4 + e, c0) : zero4();
      });
      store_tile(acc, B, i0, c0, n);
    }
  }
}

// Phase marks of chol_blocked: none on the kernels' path;
// experiments/chol_phases.cu passes one that reads clock64() after the
// panel (1), warp 0's next diagonal block (3) and the rest of the trailing
// update (2) of every step.
struct NoMarks {
  __device__ __forceinline__ void operator()(int) const {}
};

// The whole factorization of A (and, with kInv, B = L^-1 from B = I), in
// place; rinv_s holds kMaxNB floats of shared memory. Every thread of the
// CTA calls it, after a barrier.
template <int NB, bool kInv, class Mat, class Marks = NoMarks>
__device__ void chol_blocked(Mat A, Mat B, int n, float* rinv_s, Marks mark = {}) {
  static_assert(NB % kMT == 0 && NB <= kMaxNB, "the panel is read as float4s; rinv_s holds kMaxNB pivots");
  const bool warp0 = threadIdx.x < 32;
  if (warp0) factor_diag<NB>(A, 0, min(NB, n), rinv_s);
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int j1 = min(j0 + NB, n);
    const int r = j1 - j0;
    const int rows = n - j1;
    const int items = rows + (kInv ? j1 : 0);
    if (static_cast<int>(threadIdx.x) < items) {  // only threads with an item need L_jj
      float l[NB][NB], rinv[NB];
      load_diag<NB>(A, j0, r, rinv_s, l, rinv);
      for (int t = threadIdx.x; t < items; t += blockDim.x) {
        if (t < rows)
          panel_row<NB>(A, j1 + t, j0, l, rinv);
        else if constexpr (kInv)
          inv_block_col<NB>(B, t - rows, j0, r, l, rinv);
      }
    }
    __syncthreads();
    mark(1);
    if (j1 < n) {
      const int T = (n - j1 + kMT - 1) / kMT;
      const int total = tiles(T) + (kInv ? T * (j1 / kMT) : 0);
      const int next = min(tiles(NB / kMT), tiles(T));  // the tiles of the next diagonal block
      if (warp0) {  // lookahead: the next block's tiles and factor, while the other warps update the rest
        update_tiles<NB, kInv>(A, B, n, j0, j1, 0, next, threadIdx.x, 32);
        __syncwarp();
        factor_diag<NB>(A, j1, min(j1 + NB, n) - j1, rinv_s);
        mark(3);
      } else {
        update_tiles<NB, kInv>(A, B, n, j0, j1, next, total, threadIdx.x - 32, blockDim.x - 32);
      }
    }
    __syncthreads();
    mark(2);
  }
}

// The lower triangle of a row-major (n, n) source into Mat, one warp per
// row, 16-byte loads where every row is aligned (vec). Only the lower
// triangle is read; the rest of each float4 written is padding.
template <class Mat>
__device__ __forceinline__ void load_lower(const float* __restrict__ K, Mat A, int n, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5) {
    const float* row = K + static_cast<size_t>(i) * n;
    for (int k = kMT * lane; k <= i; k += 32 * kMT) {
      float4 v;
      if (vec) {
        v = *reinterpret_cast<const float4*>(row + k);
      } else {
        v.x = row[k];
        v.y = k + 1 <= i ? row[k + 1] : 0.0f;
        v.z = k + 2 <= i ? row[k + 2] : 0.0f;
        v.w = k + 3 <= i ? row[k + 3] : 0.0f;
      }
      A.store4(i, k, v);
    }
  }
}

// B = I as a Packed triangle, its padding zero.
__device__ __forceinline__ void identity_lower(Packed B, int n) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5)
    for (int k = kMT * lane; k <= i; k += 32 * kMT)
      B.store4(i, k, make_float4(k == i, k + 1 == i, k + 2 == i, k + 3 == i));
}

// The lower triangle of Mat out to a row-major (n, n) matrix, zeros above
// the diagonal; one warp per row, 16-byte stores where aligned (vec).
template <class Mat>
__device__ __forceinline__ void store_lower(Mat A, float* __restrict__ out, int n, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5) {
    float* row = out + static_cast<size_t>(i) * n;
    for (int k = kMT * lane; k < n; k += 32 * kMT) {
      float4 v = k <= i ? A.load4(i, k) : zero4();
      if (k + 1 > i) v.y = 0.0f;
      if (k + 2 > i) v.z = 0.0f;
      if (k + 3 > i) v.w = 0.0f;
      if (vec) {
        *reinterpret_cast<float4*>(row + k) = v;
      } else {
        row[k] = v.x;
        if (k + 1 < n) row[k + 1] = v.y;
        if (k + 2 < n) row[k + 2] = v.z;
        if (k + 3 < n) row[k + 3] = v.w;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

inline int optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return bytes;
}

}  // namespace zigp
