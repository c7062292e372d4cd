// The ARD RBF cross-gram of a batch of G kernels, float32, and its gradient:
//
//   K[g, i, j] = var[g] * exp(-1/2 * sum_d (X[g,i,d] - Z[g,j,d])^2 / ell[g,d]^2)
//
// Replaces zigp_tpu/ops/pallas/rbf_gram.py:rbf_gram (the Pallas TPU kernel,
// body _gram_kernel), which takes any input dimension D, and its custom VJP
// (_bwd, which XLA fuses into a few einsums and reductions). Same arithmetic:
// the exact difference form, never the expansion |x|^2 - 2 x.z + |z|^2,
// which cancels catastrophically in float32 at the pptr time column
// (t ~ 5, ell ~ 0.005). The backward keeps the difference form too, where
// _bwd expands sum W (x - z)^2 into sum W x^2 - 2 x.(W z) + sum W^T z^2 and
// loses every digit of dell there. The TPU kernel's 256 x 256 VMEM tiles and
// its padding of N and M were Mosaic's constraints; here each thread writes
// its own entries and masks the ragged edge.
//
// Every entry, forward and backward, is computed by gram_entry: acc summed
// over d in order, (x - z)^2 times 1/ell^2 by one fused multiply-add, IEEE
// expf (the build uses no --use_fast_math). So the backward's recomputed K
// has the forward's bits.
//
// Forward. Bound on Hopper: writing K. Per entry it reads nothing new (X and
// Z rows are a few floats, served from L1) and writes 4 bytes after about
// 3D + 3 flops and one expf, so the least time is G*N*M*4 bytes over
// 3.35 TB/s. Two instances:
// - rbf_gram_kernel_vec4, where M % 4 == 0, D <= 3 and the gram is large
//   enough to fill the card with its blocks (kVecMinBlocks: the 105 x 250
//   grid's (2, 250, 8192), the stacks' and the exported programs' larger
//   K_mn): a thread computes 4 adjacent columns and stores them with one
//   16-byte store, and walks 8 rows, so a warp's store is 512 contiguous
//   bytes and more of them are in flight. A block covers 128 columns by 64
//   rows.
// - rbf_gram_kernel (D = 1, 2, 3 unrolled, Z's row and 1/ell^2 in
//   registers) and rbf_gram_kernel_any_d (D read at run time, Z's row and
//   ell from L1), one column a thread, for the ragged K_mm widths (10, 32,
//   100, 105, 200, 250) and any D: threadIdx.x runs along j, the contiguous
//   dimension of K, and a block covers 32 columns by 32 rows (8 rows of
//   threads, 4 rows each).
//
// Backward (rbf_gram_bwd_kernel), one launch for the G grams, W = gK * K:
//   dX_id = -sum_j W_ij (X_id - Z_jd) / ell_d^2
//   dZ_jd =  sum_i W_ij (X_id - Z_jd) / ell_d^2
//   dell_d = sum_ij W_ij (X_id - Z_jd)^2 / ell_d^3,   dvar = sum_ij W_ij / var
// It recomputes K from X and Z rather than reading the saved one, so it reads
// gK alone: 4 bytes an entry against about 9D + 5 flops and one expf, bound
// by bytes. Each thread takes 4 adjacent columns (one 16-byte load of gK
// where the row is aligned) of a few rows, all of them loaded before the
// math, and keeps W in registers. A block is 8 warps, WC side by side along
// j (128 columns each) and 8 / WC along i, with WC the least of 1, 2, 4, 8
// that covers M, and it walks all M columns of its rows: in one chunk, 4
// rows a warp (2 for D > 3), where M <= 1024, or in chunks of 1024 columns,
// 2 rows a warp, the next chunk's loads in flight while one is used. So dX_i
// is complete in the block: reduced by warp shuffles along j, then across
// the block's column warps in shared memory, and written. dZ_j and the dell
// and dvar partials stay in the thread's registers across its rows and are
// reduced across warps in shared memory into scratch (allocated by the
// caller); the last block to finish (an integer ticket, which it resets, so
// the launch can be replayed in a CUDA graph) sums them over the blocks in a
// fixed order: no floating-point atomics. The tiles depend on N and M alone,
// never on G, on g or on a shared side's stride, so a kernel's gradient has
// the same bits alone, in a batch, or in a member stack folded into G. A
// side shared by the G kernels (stride 0) that takes a gradient gets the sum
// over g of the per-g gradients, in order.
//
// Strides: X and Z are row-major (N, D) and (M, D) blocks, one per g, at a
// distance of x_gstride and z_gstride floats; a stride of 0 shares one block
// across the batch (the minibatch x_p, used by both GPs of the pair, is not
// copied). ell is (G, D) and var is (G,), both contiguous; K and gK are
// (G, N, M), contiguous.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// acc + (x - z)^2 / ell^2 and the entry, for every kernel of this file.
__device__ __forceinline__ float add_sq(float acc, float diff, float inv_ell2) {
  return __fmaf_rn(__fmul_rn(diff, diff), inv_ell2, acc);
}

__device__ __forceinline__ float gram_entry(float var, float acc) {
  return __fmul_rn(var, expf(__fmul_rn(-0.5f, acc)));
}

constexpr int kTileJ = 32;  // threads along j
constexpr int kTileI = 8;   // threads along i
constexpr int kRows = 4;    // rows of K per thread

template <int D>
__global__ void __launch_bounds__(kTileJ * kTileI)
rbf_gram_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                const float* __restrict__ ell, const float* __restrict__ var,
                float* __restrict__ K, int N, int M, long long x_gstride,
                long long z_gstride) {
  const int g = blockIdx.z;
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  if (j >= M) return;
  X += g * x_gstride;
  Z += g * z_gstride;
  K += static_cast<size_t>(g) * N * M;

  float inv_ell2[D];
  float z[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float l = ell[g * D + d];
    inv_ell2[d] = 1.0f / (l * l);
    z[d] = Z[static_cast<size_t>(j) * D + d];
  }
  const float v = var[g];

  const int i0 = blockIdx.y * (kTileI * kRows) + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kTileI;
    if (i >= N) break;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc = add_sq(acc, X[static_cast<size_t>(i) * D + d] - z[d], inv_ell2[d]);
    K[static_cast<size_t>(i) * M + j] = gram_entry(v, acc);
  }
}

// The same entries for a D known only at run time.
__global__ void __launch_bounds__(kTileJ * kTileI)
rbf_gram_kernel_any_d(const float* __restrict__ X, const float* __restrict__ Z,
                      const float* __restrict__ ell, const float* __restrict__ var,
                      float* __restrict__ K, int N, int M, int D, long long x_gstride,
                      long long z_gstride) {
  const int g = blockIdx.z;
  const int j = blockIdx.x * kTileJ + threadIdx.x;
  if (j >= M) return;
  X += g * x_gstride;
  Z += g * z_gstride + static_cast<size_t>(j) * D;
  ell += g * D;
  K += static_cast<size_t>(g) * N * M;
  const float v = var[g];

  const int i0 = blockIdx.y * (kTileI * kRows) + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kTileI;
    if (i >= N) break;
    const float* x = X + static_cast<size_t>(i) * D;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float l = ell[d];
      acc = add_sq(acc, x[d] - Z[d], 1.0f / (l * l));
    }
    K[static_cast<size_t>(i) * M + j] = gram_entry(v, acc);
  }
}

constexpr int kVecCols = 4;   // adjacent columns per thread, one 16-byte store
constexpr int kVecRows = 8;   // rows per thread
constexpr int kVecTileJ = kTileJ * kVecCols;   // 128 columns a block
constexpr int kVecTileI = kTileI * kVecRows;   // 64 rows a block

// M % 4 == 0 and K 16-byte aligned: 4 columns and 8 rows a thread.
template <int D>
__global__ void __launch_bounds__(kTileJ * kTileI)
rbf_gram_kernel_vec4(const float* __restrict__ X, const float* __restrict__ Z,
                     const float* __restrict__ ell, const float* __restrict__ var,
                     float* __restrict__ K, int N, int M, long long x_gstride,
                     long long z_gstride) {
  const int g = blockIdx.z;
  const int j = (blockIdx.x * kTileJ + threadIdx.x) * kVecCols;
  if (j >= M) return;  // M % 4 == 0: the thread's 4 columns are all in range
  X += g * x_gstride;
  Z += g * z_gstride;
  K += static_cast<size_t>(g) * N * M;

  float inv_ell2[D];
  float z[kVecCols][D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float l = ell[g * D + d];
    inv_ell2[d] = 1.0f / (l * l);
#pragma unroll
    for (int c = 0; c < kVecCols; ++c) z[c][d] = Z[static_cast<size_t>(j + c) * D + d];
  }
  const float v = var[g];

  const int i0 = blockIdx.y * kVecTileI + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kVecRows; ++r) {
    const int i = i0 + r * kTileI;
    if (i >= N) break;
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = X[static_cast<size_t>(i) * D + d];
    float out[kVecCols];
#pragma unroll
    for (int c = 0; c < kVecCols; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = add_sq(acc, x[d] - z[c][d], inv_ell2[d]);
      out[c] = gram_entry(v, acc);
    }
    *reinterpret_cast<float4*>(K + static_cast<size_t>(i) * M + j) = make_float4(out[0], out[1], out[2], out[3]);
  }
}

dim3 grid_of(int G, int N, int M) {
  return dim3((M + kTileJ - 1) / kTileJ, (N + kTileI * kRows - 1) / (kTileI * kRows), G);
}

dim3 vec_grid_of(int G, int N, int M) {
  return dim3((M + kVecTileJ - 1) / kVecTileJ, (N + kVecTileI - 1) / kVecTileI, G);
}

// The 4-column instance's blocks hold 8 times the one-column instance's
// entries; below about 3 of them an SM (H100: 132 SMs) the card is not full
// and the one-column instance, with more threads in flight, is faster.
constexpr long long kVecMinBlocks = 384;

template <int D>
cudaError_t launch(const float* X, const float* Z, const float* ell,
                   const float* var, float* K, int G, int N, int M,
                   long long xg, long long zg, cudaStream_t stream) {
  const dim3 vg = vec_grid_of(G, N, M);
  const bool vec = M % kVecCols == 0 && reinterpret_cast<std::uintptr_t>(K) % 16 == 0 &&
                   static_cast<long long>(vg.x) * vg.y * vg.z >= kVecMinBlocks;
  if (vec)
    rbf_gram_kernel_vec4<D><<<vg, dim3(kTileJ, kTileI), 0, stream>>>(X, Z, ell, var, K, N, M, xg, zg);
  else
    rbf_gram_kernel<D><<<grid_of(G, N, M), dim3(kTileJ, kTileI), 0, stream>>>(X, Z, ell, var, K, N, M, xg, zg);
  return cudaGetLastError();
}

// --- the backward ---------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdCols = 4;                // adjacent columns per thread
constexpr int kWarpCols = 32 * kBwdCols;   // 128 columns a warp
constexpr int kMaxDims = 8;                // gradient dimensions a launch (the run-time-D instance)
constexpr int kSlots = 256;                // tickets: one per stream the caller names

__device__ unsigned int g_blocks_done[kSlots];

enum : int {
  kNeedX = 1, kNeedZ = 2, kNeedEll = 4, kNeedVar = 8,
  kSumX = 16,   // X is shared by the G kernels: dX summed over g
  kSumZ = 32,
  kVecLoad = 64,  // gK's rows are 16-byte aligned: float4 loads
};

// The tile plan, from N, M and D alone (never G): wc warps side by side
// along j (128 columns each; the least power of 2 up to 8 that covers M),
// 8 / wc along i, `rows` rows a warp, and `tiles` blocks along i for each g.
// A block walks all M columns, in `chunks` of 128 wc: where M > 1024 (K_mn
// at the minibatch's width) a warp takes 2 rows and M / 1024 chunks, else
// one chunk of 4 rows (2 for D > 3). The rows are unrolled, so more of them
// is more code for every warp to fetch; on an H100 8 rows a warp were
// slower than 4 at every one-chunk shape of the path, and 4 than 2 at D = 5.
struct BwdPlan {
  int wc, wr, rows, chunks, tiles;
};

__host__ __device__ BwdPlan bwd_plan(int N, int M, int D) {
  BwdPlan p;
  p.wc = 1;
  while (p.wc < kBwdWarps && p.wc * kWarpCols < M) p.wc *= 2;
  p.wr = kBwdWarps / p.wc;
  p.chunks = (M + p.wc * kWarpCols - 1) / (p.wc * kWarpCols);
  p.rows = p.chunks > 1 || D > 3 ? 2 : 4;
  p.tiles = (N + p.wr * p.rows - 1) / (p.wr * p.rows);
  return p;
}

struct BwdArgs {
  const float* X;
  const float* Z;
  const float* ell;
  const float* var;
  const float* gK;
  float* dX;
  float* dZ;
  float* dell;
  float* dvar;
  float* part_x;  // (G, N, dc): dX of each kernel, where X is shared (kSumX)
  float* part_z;  // (G, tiles, M, dc): dZ's sums over each block's rows
  float* part_l;  // (G, tiles, dc + 1): each block's dell and dvar sums
  long long xg, zg;
  int N, M, D;
  int d0, dc;     // this launch's gradient dimensions: [d0, d0 + dc)
  int flags;
  int slot;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[u] = sum_t p[u][t * stride], t = 0 .. n - 1 in order, for up to 4 sums
// at once (a null p[u] sums nothing): 16 loads in flight. How many sums run
// at once does not change any sum's order.
__device__ __forceinline__ void sum4(const float* const* p, int n, size_t stride, float (&s)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) s[u] = 0.0f;
  int t = 0;
  for (; t + 4 <= n; t += 4) {
    float v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) v[q][u] = p[u] ? __ldcg(p[u] + (t + q) * stride) : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += v[q][u];
  }
  for (; t < n; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] += p[u] ? __ldcg(p[u] + t * stride) : 0.0f;
}

// The last block: sums the blocks' partials in a fixed order and writes dZ,
// a shared X's dX, dell and dvar. Each output's order of summation depends
// on N and M alone.
__device__ void bwd_finish(const BwdArgs& a, int dc, int tiles) {
  const int G = gridDim.y, N = a.N, M = a.M, D = a.D;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (a.flags & kNeedZ) {
    const size_t stride = static_cast<size_t>(M) * dc;  // between tiles
    if (!(a.flags & kSumZ)) {
      const int nout = G * M * dc;
      for (int o0 = threadIdx.x; o0 < nout; o0 += 4 * kBwdThreads) {
        const float* p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int o = o0 + u * kBwdThreads, k = o % dc, j = (o / dc) % M, g = o / (dc * M);
          p[u] = o < nout ? a.part_z + (static_cast<size_t>(g) * tiles * M + j) * dc + k : nullptr;
        }
        float s[4];
        sum4(p, tiles, stride, s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int o = o0 + u * kBwdThreads, k = o % dc, j = (o / dc) % M, g = o / (dc * M);
          if (o >= nout) break;
          const float l = a.ell[g * D + a.d0 + k];
          a.dZ[(static_cast<size_t>(g) * M + j) * D + a.d0 + k] = s[u] * (1.0f / (l * l));
        }
      }
    } else {
      for (int o = threadIdx.x; o < M * dc; o += kBwdThreads) {
        const int k = o % dc, j = o / dc;
        float total = 0.0f;
        for (int g = 0; g < G; ++g) {
          const float* p[4] = {a.part_z + (static_cast<size_t>(g) * tiles * M + j) * dc + k, nullptr, nullptr,
                               nullptr};
          float s[4];
          sum4(p, tiles, stride, s);
          const float l = a.ell[g * D + a.d0 + k];
          total += s[0] * (1.0f / (l * l));
        }
        a.dZ[static_cast<size_t>(j) * D + a.d0 + k] = total;
      }
    }
  }
  if ((a.flags & kNeedX) && (a.flags & kSumX)) {
    for (int o = threadIdx.x; o < N * dc; o += kBwdThreads) {
      const int k = o % dc, i = o / dc;
      float total = 0.0f;
      for (int g = 0; g < G; ++g) total += __ldcg(a.part_x + (static_cast<size_t>(g) * N + i) * dc + k);
      a.dX[static_cast<size_t>(i) * D + a.d0 + k] = total;
    }
  }
  if (!(a.flags & (kNeedEll | kNeedVar))) return;
  // dell and dvar: a warp an output, its lanes over the tiles, up to 8
  // outputs a warp at once.
  constexpr int kAtOnce = 8;
  const int nout = G * (dc + 1);
  for (int o0 = w; o0 < nout; o0 += kAtOnce * kBwdWarps) {
    float s[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) s[u] = 0.0f;
    for (int t = lane; t < tiles; t += 32)
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        const int o = o0 + u * kBwdWarps;
        if (o < nout) s[u] += __ldcg(a.part_l + (static_cast<size_t>(o / (dc + 1)) * tiles + t) * (dc + 1) + o % (dc + 1));
      }
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      const int o = o0 + u * kBwdWarps, g = o / (dc + 1), k = o % (dc + 1);
      const float v = warp_sum(s[u]);
      if (lane != 0 || o >= nout) continue;
      if (k < dc && (a.flags & kNeedEll)) {
        const float l = a.ell[g * D + a.d0 + k];
        a.dell[g * D + a.d0 + k] = v / (l * l * l);
      } else if (k == dc && (a.flags & kNeedVar)) {
        a.dvar[g] = v / a.var[g];
      }
    }
  }
}

// DT = D (1, 2, 3), or 0: D at run time, dc <= kMaxDims gradient dimensions
// from d0 (all of them where D <= kMaxDims). Z's dimensions are in registers
// where D <= kMaxDims, else its rows and X's are read from L1. R: the plan's
// rows a warp (2: any number of chunks of columns, the next one's loads in
// flight; 4: one chunk).
template <int DT, int R>
__global__ void __launch_bounds__(kBwdThreads) rbf_gram_bwd_kernel(const BwdArgs a) {
  constexpr int DR = DT ? DT : kMaxDims;
  constexpr int DZ = DT ? DT : kMaxDims;  // Z's dimensions kept in registers
  const int D = DT ? DT : a.D, dc = DT ? DT : a.dc, d0 = DT ? 0 : a.d0;
  const bool z_in_regs = DT || D <= kMaxDims;  // then d0 == 0 and dc == D
  const int N = a.N, M = a.M;
  const BwdPlan p = bwd_plan(N, M, D);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, wj = w % p.wc, wi = w / p.wc;
  const int g = blockIdx.y, it = blockIdx.x;
  const int tile_i = p.wr * R;
  const int iw = it * tile_i + wi * R;  // the warp's first row
  const bool need_x = a.flags & kNeedX, need_z = a.flags & kNeedZ;
  const bool need_l = a.flags & (kNeedEll | kNeedVar);
  const bool vec = a.flags & kVecLoad;

  __shared__ float s_dx[kBwdWarps][R][DR];
  __shared__ float s_dz[kBwdWarps][kWarpCols][DR];
  __shared__ float s_red[kBwdWarps][DR + 1];
  __shared__ bool s_last;

  const float* X = a.X + g * a.xg;
  const float* Z = a.Z + g * a.zg;
  const float* gK = a.gK + static_cast<size_t>(g) * N * M;
  const float v = a.var[g];

  float inv[DR];  // 1/ell^2 of the gradient dimensions (all of them for DT)
#pragma unroll
  for (int k = 0; k < DR; ++k) {
    const float l = (DT || k < dc) ? a.ell[g * D + d0 + k] : 1.0f;
    inv[k] = 1.0f / (l * l);
  }
  float xs[R][DT ? DT : 1];  // X's rows (DT; the run-time-D instance reads them from L1)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < (DT ? DT : 1); ++d) xs[r][d] = DT && iw + r < N ? X[static_cast<size_t>(iw + r) * D + d] : 0.0f;

  float dxr[R][DR], dz[kBwdCols][DR], dl[DR], dv = 0.0f;
#pragma unroll
  for (int k = 0; k < DR; ++k) {
    dl[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) dxr[r][k] = 0.0f;
  }

  // gK of a chunk's R rows and Z's rows of its 4 columns, into registers:
  // the next chunk's are in flight while this one's are used.
  float gk[R][kBwdCols], zr[kBwdCols][DZ], gk_next[R][kBwdCols], zr_next[kBwdCols][DZ];
  auto load = [&](float (&gd)[R][kBwdCols], float (&zd)[kBwdCols][DZ], int ch) {
    const int j = (ch * p.wc + wj) * kWarpCols + lane * kBwdCols;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = iw + r;
      const float* grow = gK + static_cast<size_t>(i) * M + j;
      if (i < N && vec && j + kBwdCols <= M) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(grow));
        gd[r][0] = q.x, gd[r][1] = q.y, gd[r][2] = q.z, gd[r][3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < kBwdCols; ++c) gd[r][c] = i < N && j + c < M ? __ldg(grow + c) : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
      for (int d = 0; d < DZ; ++d)
        zd[c][d] = z_in_regs && d < D && j + c < M ? Z[static_cast<size_t>(j + c) * D + d] : 0.0f;
  };

  const bool rows_in = iw < N;
  if (rows_in) load(gk, zr, 0);
  for (int ch = 0; ch < p.chunks; ++ch) {
    const int jw = (ch * p.wc + wj) * kWarpCols;  // the warp's first column
    const int j = jw + lane * kBwdCols;           // the thread's first column
    const bool next = R == 2 && rows_in && ch + 1 < p.chunks;  // R == 4: one chunk
    if (next) load(gk_next, zr_next, ch + 1);
#pragma unroll
    for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
      for (int k = 0; k < DR; ++k) dz[c][k] = 0.0f;
    if (rows_in && jw < M) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = iw + r;
        if (i >= N) break;
        const float* xrow = X + static_cast<size_t>(i) * D;
        float x[DR];
#pragma unroll
        for (int k = 0; k < DR; ++k) x[k] = DT ? xs[r][DT ? k : 0] : (k < dc ? xrow[d0 + k] : 0.0f);
#pragma unroll
        for (int c = 0; c < kBwdCols; ++c) {
          if (j + c >= M) break;
          float acc = 0.0f;
          if (z_in_regs) {
#pragma unroll
            for (int d = 0; d < DZ; ++d) {
              if (!DT && d >= D) break;
              acc = add_sq(acc, x[d] - zr[c][d], inv[d]);
            }
          } else {
            const float* zrow = Z + static_cast<size_t>(j + c) * D;
            for (int d = 0; d < D; ++d) {
              const float l = a.ell[g * D + d];
              acc = add_sq(acc, xrow[d] - zrow[d], 1.0f / (l * l));
            }
          }
          const float W = gk[r][c] * gram_entry(v, acc);
          dv += W;
#pragma unroll
          for (int k = 0; k < DR; ++k) {
            if (!DT && k >= dc) break;
            const float diff = x[k] - (z_in_regs ? zr[c][k] : Z[static_cast<size_t>(j + c) * D + d0 + k]);
            const float wd = W * diff;
            dxr[r][k] += wd;
            dz[c][k] += wd;
            dl[k] += wd * diff;
          }
        }
      }
    }
    if (need_z && p.wr == 1 && rows_in) {  // the warp alone holds these columns' sums over the block's rows
#pragma unroll
      for (int c = 0; c < kBwdCols; ++c) {
        if (j + c >= M) break;
#pragma unroll
        for (int k = 0; k < DR; ++k)
          if (DT || k < dc) a.part_z[((static_cast<size_t>(g) * p.tiles + it) * M + j + c) * dc + k] = dz[c][k];
      }
    }
    if (next) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kBwdCols; ++c) gk[r][c] = gk_next[r][c];
#pragma unroll
      for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
        for (int d = 0; d < DZ; ++d) zr[c][d] = zr_next[c][d];
    }
  }

  const int warps_j = min(p.wc, (M + kWarpCols - 1) / kWarpCols);  // column warps with columns in M
  const int rows_block = min(tile_i, N - it * tile_i);

  // dX: each row's sum over all M columns, within the block.
  if (need_x) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < DR; ++k) {
        const float s = warp_sum(dxr[r][k]);
        if (lane == 0) s_dx[w][r][k] = s;
      }
    __syncthreads();
    for (int t = threadIdx.x; t < rows_block * dc; t += kBwdThreads) {
      const int rb = t / dc, k = t % dc, wi2 = rb / R, r = rb % R, i = it * tile_i + rb;
      float s = 0.0f;
      for (int q = 0; q < warps_j; ++q) s += s_dx[wi2 * p.wc + q][r][k];
      const float l = a.ell[g * D + d0 + k];
      const float val = -s * (1.0f / (l * l));
      if (a.flags & kSumX)
        a.part_x[(static_cast<size_t>(g) * N + i) * dc + k] = val;
      else
        a.dX[(static_cast<size_t>(g) * N + i) * D + d0 + k] = val;
    }
  }
  // dZ where the block's row warps share columns (one chunk): their sums.
  if (need_z && p.wr > 1) {
    if (rows_in) {
#pragma unroll
      for (int c = 0; c < kBwdCols; ++c)
#pragma unroll
        for (int k = 0; k < DR; ++k) s_dz[w][lane * kBwdCols + c][k] = dz[c][k];
    }
    __syncthreads();
    const int rows_warps = min(p.wr, (N - it * tile_i + R - 1) / R);  // row warps inside N
    for (int t = threadIdx.x; t < M * dc; t += kBwdThreads) {
      const int col = t / dc, k = t % dc, q = col / kWarpCols, cw = col % kWarpCols;
      float s = 0.0f;
      for (int pw = 0; pw < rows_warps; ++pw) s += s_dz[pw * p.wc + q][cw][k];
      a.part_z[((static_cast<size_t>(g) * p.tiles + it) * M + col) * dc + k] = s;
    }
  }
  // dell and dvar: this block's sums.
  if (need_l) {
#pragma unroll
    for (int k = 0; k < DR; ++k) {
      const float s = warp_sum(dl[k]);
      if (lane == 0) s_red[w][k] = s;
    }
    const float s = warp_sum(dv);
    if (lane == 0) s_red[w][DR] = s;
    __syncthreads();
    if (threadIdx.x <= dc) {
      const int k = threadIdx.x == dc ? DR : threadIdx.x;
      float t = 0.0f;
      for (int q = 0; q < kBwdWarps; ++q) t += s_red[q][k];
      a.part_l[(static_cast<size_t>(g) * p.tiles + it) * (dc + 1) + threadIdx.x] = t;
    }
  }
  if (!(need_z || need_l || (need_x && (a.flags & kSumX)))) return;  // dX alone: written above

  // The last block to finish sums every block's partials.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&g_blocks_done[a.slot], 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  bwd_finish(a, dc, p.tiles);
  if (threadIdx.x == 0) g_blocks_done[a.slot] = 0;
}

}  // namespace

// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success). The caller has checked shapes, strides and
// dtypes and made the tensors' device current.
extern "C" int zigp_rbf_gram_f32(const void* X, const void* Z, const void* ell,
                                 const void* var, void* K, int G, int N, int M,
                                 int D, long long x_gstride, long long z_gstride,
                                 void* stream) {
  if (G < 1 || G > 65535 || N < 1 || M < 1 || D < 1 || (N + kTileI * kRows - 1) / (kTileI * kRows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(X);
  const auto* z = static_cast<const float*>(Z);
  const auto* l = static_cast<const float*>(ell);
  const auto* v = static_cast<const float*>(var);
  auto* k = static_cast<float*>(K);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1: err = launch<1>(x, z, l, v, k, G, N, M, x_gstride, z_gstride, s); break;
    case 2: err = launch<2>(x, z, l, v, k, G, N, M, x_gstride, z_gstride, s); break;
    case 3: err = launch<3>(x, z, l, v, k, G, N, M, x_gstride, z_gstride, s); break;
    default:
      rbf_gram_kernel_any_d<<<grid_of(G, N, M), dim3(kTileJ, kTileI), 0, s>>>(x, z, l, v, k, N, M, D,
                                                                               x_gstride, z_gstride);
      err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The scratch floats one backward launch needs (0 for shapes it refuses):
// the partials of a shared X's dX, of dZ and of dell with dvar, for `dc`
// gradient dimensions and the flags' gradients.
extern "C" long long zigp_rbf_gram_bwd_scratch(int G, int N, int M, int D, int dc, int flags) {
  if (G < 1 || N < 1 || M < 1 || D < 1 || dc < 1 || dc > kMaxDims) return 0;
  const BwdPlan p = bwd_plan(N, M, D);
  long long n = static_cast<long long>(G) * p.tiles * (dc + 1);
  if ((flags & kNeedX) && (flags & kSumX)) n += static_cast<long long>(G) * N * dc;
  if (flags & kNeedZ) n += static_cast<long long>(G) * p.tiles * M * dc;
  return n;
}

// The gradient of sum(gK * K) for the gradient dimensions [d0, d0 + dc)
// (dc <= 8; all D when D <= 3): dX (G, N, D) or (N, D) with kSumX, dZ
// likewise, dell (G, D), dvar (G,), each written where its flag asks (dvar
// also needs d0 == 0). `scratch` holds zigp_rbf_gram_bwd_scratch floats;
// `slot` (0..255) names the ticket of the launch's stream. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int zigp_rbf_gram_bwd_f32(const void* X, const void* Z, const void* ell, const void* var,
                                     const void* gK, void* dX, void* dZ, void* dell, void* dvar,
                                     void* scratch, int G, int N, int M, int D, int d0, int dc,
                                     long long x_gstride, long long z_gstride, int flags, int slot,
                                     void* stream) {
  const bool exact = D <= 3 && d0 == 0 && dc == D;
  if (G < 1 || G > 65535 || N < 1 || M < 1 || D < 1 || d0 < 0 || dc < 1 || dc > kMaxDims || d0 + dc > D ||
      slot < 0 || slot >= kSlots || (D <= 3 && !exact))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((flags & kVecLoad) && (M % kBwdCols != 0 || reinterpret_cast<std::uintptr_t>(gK) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan p = bwd_plan(N, M, D);
  BwdArgs a;
  a.X = static_cast<const float*>(X);
  a.Z = static_cast<const float*>(Z);
  a.ell = static_cast<const float*>(ell);
  a.var = static_cast<const float*>(var);
  a.gK = static_cast<const float*>(gK);
  a.dX = static_cast<float*>(dX);
  a.dZ = static_cast<float*>(dZ);
  a.dell = static_cast<float*>(dell);
  a.dvar = static_cast<float*>(dvar);
  float* s = static_cast<float*>(scratch);
  a.part_l = s;
  s += static_cast<size_t>(G) * p.tiles * (dc + 1);
  a.part_x = s;
  if ((flags & kNeedX) && (flags & kSumX)) s += static_cast<size_t>(G) * N * dc;
  a.part_z = s;
  a.xg = x_gstride;
  a.zg = z_gstride;
  a.N = N, a.M = M, a.D = D, a.d0 = d0, a.dc = dc;
  a.flags = flags;
  a.slot = slot;
  const dim3 grid(p.tiles, G);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((exact ? D : 0) * 2 + (p.rows == 4)) {  // the run-time-D instance always takes 2 rows
    case 2: rbf_gram_bwd_kernel<1, 2><<<grid, kBwdThreads, 0, st>>>(a); break;
    case 3: rbf_gram_bwd_kernel<1, 4><<<grid, kBwdThreads, 0, st>>>(a); break;
    case 4: rbf_gram_bwd_kernel<2, 2><<<grid, kBwdThreads, 0, st>>>(a); break;
    case 5: rbf_gram_bwd_kernel<2, 4><<<grid, kBwdThreads, 0, st>>>(a); break;
    case 6: rbf_gram_bwd_kernel<3, 2><<<grid, kBwdThreads, 0, st>>>(a); break;
    case 7: rbf_gram_bwd_kernel<3, 4><<<grid, kBwdThreads, 0, st>>>(a); break;
    default: rbf_gram_bwd_kernel<0, 2><<<grid, kBwdThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
