// y = (A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x, for a batch of G pairs of square float32
// factors.
//
// Replaces zigp_tpu/ops/pallas/kron_matvec.py:kron_mv_2 (the Pallas TPU
// kernel _kron_mv_kernel). Same contraction: x of one pair is X (Ma, Mb),
// row-major (i_a, i_b); T = X Bopᵀ, then Y = Aop T, y = vec(Y) row-major,
// with Aop = A and Bop = B, or Aᵀ and Bᵀ for the transposed product
// (Aᵀ ⊗ Bᵀ) x = vec(Aᵀ X B) that the L⁻ᵀ pass of a Kronecker solve needs.
// The factors are general (nothing assumes them triangular or symmetric),
// and no transposed copy is made: the orientation is a stride of the staging.
//
// What bounds it on Hopper: 2 G Ma Mb (Ma + Mb) flops against
// (Ma² + Mb² + 2 Ma Mb) G 4 bytes. At the serving route's (2; 105, 250) that
// is 37 MFLOP, 0.56 µs at 67 TFLOP/s of f32 outside the tensor cores
// (operations); at (2; 10, 100) the launch itself. What it meets in practice
// is issue and latency: few CTAs, each a chain of staged chunks, so the
// design spreads Y over as many CTAs and warps as the cluster allows
// (experiments/kron_phases.py shows the cycles of each phase). The product
// stands in for a triangular solve, so it stays in plain f32 FMAs (no tensor
// cores, no TF32, no --use_fast_math).
//
// Design. A CTA owns a TM × TN tile of Y of one pair (TM = TN = 16 in the
// library) and runs TM·TN threads: four k-groups, each thread of a group
// holding a 4-row × 1-column micro-tile in registers (four independent FMA
// chains; per k one float4 of the row operand, broadcast across the threads
// of a row group, and one scalar of the column operand, consecutive words:
// two shared memory wavefronts per 128 FMAs). Group s takes k = 8s … 8s + 7
// of every 32-wide chunk; at the end the four partial sums are added in the
// order of s through shared memory, each thread then owning one output. Both
// products go through this loop: P (rows × k) and Q (columns × k) are staged
// chunk by chunk into a ring of 8 chunks in shared memory, as [k][row] and
// [k][column], by 4-byte cp.async (zero-filled past the edges, so ragged
// shapes need no special case), with up to 7 chunks in flight: all of
// Mb ≤ 256. The orientation is absorbed in the staging's strides, so the
// inner loop is the same for both.
//
// Cluster instance (⌈Ma / TM⌉ ≤ 8, which covers the serving route): the
// ⌈Ma / TM⌉ CTAs of one column slab form a thread-block cluster along grid
// x, so (2; 105, 250) runs 7 × 16 × 2 = 224 CTAs of 256 threads.
//   1. Each CTA computes its TM rows of the slab of T, T[rows, slab] =
//      X[rows, :] Bop[slab, :]ᵀ, over k < Mb. Its rows of Aop, for step 3,
//      are staged at the start and arrive during this step.
//   2. Cluster barrier; each CTA copies its peers' rows of T from their
//      shared memory (distributed shared memory) into its own slab of T
//      (Ma × TN floats, 6.7 KB at Ma = 105, TN = 16), so no intermediate goes
//      through device memory. It then arrives on a second cluster barrier.
//   3. Y[rows, slab] = Aop[rows, :] T[:, slab], stored coalesced; then the
//      CTA waits on the second barrier before it exits, because a peer may
//      still be reading its shared memory.
//
// Global instance (Ma > 8 TM, off the serving route): one CTA per column
// slab walks every row tile with the same loops, its slab of T going through
// a global scratch buffer that no other CTA touches (G × slabs × Ma × TN
// floats), so one __syncthreads() orders the two products. It takes any Ma.
//
// The caller picks the instance (kron_matvec.plan is the one place the
// choice is made): a null scratch launches the cluster instance, which is
// refused past the cluster's reach, and a scratch buffer the global one.
// The library builds the 16 × 16 tile only, the fastest of the tiles swept
// at both serving shapes on an H100; experiments/kron_phases.cu includes
// this file to build and time the others.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

// Phase marks for experiments/kron_phases.cu, which includes this file with
// KRON_MARK defined; empty in the library.
#ifndef KRON_MARK
#define KRON_MARK(k)
#endif

namespace {

constexpr int kChunk = 32;               // k per staged chunk
constexpr int kStages = 8;               // chunks in the ring: up to 7 in flight
constexpr int kSplit = 4;                // k-groups per CTA
constexpr int kShare = kChunk / kSplit;  // k of each chunk per group
constexpr int kMaxCluster = 8;           // CTAs per cluster: the portable limit

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile's geometry: threads, shared-memory strides and the ring's size.
template <int TM, int TN>
struct Geo {
  static constexpr int kGroup = TM / 4 * TN;        // threads of one k-group
  static constexpr int kThreads = kSplit * kGroup;  // = TM * TN
  static constexpr int LDP = TM + 4;                // [k][row], rows float4-aligned
  static constexpr int LDQ = TN + 1;                // [k][column], staged without bank conflicts
  static constexpr int kP = kChunk * LDP, kQ = kChunk * LDQ;
  static constexpr int kRing = kStages * (kP + kQ);  // floats
  static constexpr int kRed = 4 * kThreads;          // floats of the k-groups' partial sums
  // CTAs an SM must hold at once, for __launch_bounds__: it lets ptxas give
  // the 16 × 16 tile 63 registers where its own choice was about 40, which
  // ran faster on an H100 (chip_smoke.py's kernel rows).
  static constexpr int kMinCtas = kThreads < 1024 ? 2 : 1;
};

// Element (r, c) of a strided matrix at p[r * sr + c * sc], zero outside
// r < nr, c < nc. Rows are the output's rows or columns, c is k.
struct View {
  const float* p;
  int sr, sc, nr, nc;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// One thread's share of staging rows r0 … r0 + R - 1 of a View, a chunk of
// kChunk k at a time, as cp.async copies into dst[kk * ld + i]: consecutive
// threads take consecutive addresses of whichever index the View is
// contiguous in. The addresses are worked out once; a chunk adds k0.
template <int R, int kThreads>
struct Stager {
  static constexpr int kE = ceil_div(R * kChunk, kThreads);  // elements per thread per chunk
  const float* src[kE];
  int dst[kE], kk[kE];  // kk < 0: no element; kk past nc: zero-filled in every chunk

  __device__ __forceinline__ Stager(const View& v, int r0, int ld) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int i = v.sc == 1 ? idx / kChunk : idx % R, k = v.sc == 1 ? idx % kChunk : idx / R;
      const bool row = r0 + i < v.nr;
      src[e] = row ? v.p + static_cast<size_t>(r0 + i) * v.sr + static_cast<size_t>(k) * v.sc : v.p;
      dst[e] = k * ld + i;
      kk[e] = idx >= R * kChunk ? -1 : row ? k : v.nc;
    }
  }

  __device__ __forceinline__ void operator()(float* slot, const View& v, int k0) const {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (kk[e] < 0) continue;
      const bool ok = k0 + kk[e] < v.nc;
      cp_async4(slot + dst[e], ok ? src[e] + static_cast<size_t>(k0) * v.sc : v.p, ok);
    }
  }
};

// acc[e] += Σ P[kk][4 ti4 + e] · Q[kk][tj] over this group's kShare k of
// one chunk (k0 = 8 s): one broadcast float4 and one scalar per four FMAs.
// The share's loads are written before its FMAs so that ptxas may issue
// them together; how far it does depends on the registers it allows itself
// (Geo::kMinCtas).
template <int LDP, int LDQ>
__device__ __forceinline__ void fma_share(const float* P, const float* Q, int k0, int ti4, int tj, float4& acc) {
  float4 a[kShare];
  float b[kShare];
#pragma unroll
  for (int u = 0; u < kShare; ++u) {
    a[u] = *reinterpret_cast<const float4*>(P + (k0 + u) * LDP + 4 * ti4);
    b[u] = Q[(k0 + u) * LDQ + tj];
  }
#pragma unroll
  for (int u = 0; u < kShare; ++u) {
    acc.x = fmaf(a[u].x, b[u], acc.x);
    acc.y = fmaf(a[u].y, b[u], acc.y);
    acc.z = fmaf(a[u].z, b[u], acc.z);
    acc.w = fmaf(a[u].w, b[u], acc.w);
  }
}

// The k-groups' partial sums added in the order of s: thread (s, t) gets
// row 4 ti4 + s, column tj of the tile. Leaves `red`, and the stage ring,
// free for the next call.
template <int TM, int TN>
__device__ __forceinline__ float reduce_groups(float4 part, float4* red) {
  using G = Geo<TM, TN>;
  const int s = threadIdx.x / G::kGroup, t = threadIdx.x % G::kGroup;
  red[threadIdx.x] = part;
  __syncthreads();
  const float* r = reinterpret_cast<const float*>(red);
  float v = r[4 * t + s];
#pragma unroll
  for (int q = 1; q < kSplit; ++q) v += r[4 * (q * G::kGroup + t) + s];
  __syncthreads();
  return v;
}

// Σ_{k < nk} P(i0 + 4 ti4 + s, k) · Q(j0 + tj, k) for this thread's output:
// P and Q staged chunk by chunk through the ring (kStages - 1 chunks ahead),
// each group multiplying its share of a chunk, then the groups reduced. A
// cp.async group committed before the call is complete with the first chunk.
template <int TM, int TN>
__device__ float tile_product(const View& P, const View& Q, int i0, int j0, int nk, float* ring, float4* red) {
  using G = Geo<TM, TN>;
  float* Ps = ring;                  // [kStages][kChunk][LDP]
  float* Qs = ring + kStages * G::kP;  // [kStages][kChunk][LDQ]
  const int s = threadIdx.x / G::kGroup, t = threadIdx.x % G::kGroup;
  const int chunks = ceil_div(nk, kChunk);
  const Stager<TM, G::kThreads> sp(P, i0, G::LDP);
  const Stager<TN, G::kThreads> sq(Q, j0, G::LDQ);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      sp(Ps + c * G::kP, P, c * kChunk);
      sq(Qs + c * G::kQ, Q, c * kChunk);
    }
    cp_async_commit();  // one group per chunk, empty past the last
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is here for every thread, and chunk c - 1's slot is consumed
    const int next = c + kStages - 1;
    if (next < chunks) {
      const int slot = next % kStages;
      sp(Ps + slot * G::kP, P, next * kChunk);
      sq(Qs + slot * G::kQ, Q, next * kChunk);
    }
    cp_async_commit();
    const int slot = c % kStages;
    fma_share<G::LDP, G::LDQ>(Ps + slot * G::kP, Qs + slot * G::kQ, s * kShare, t / TN, t % TN, acc);
  }
  return reduce_groups<TM, TN>(acc, red);
}

struct Pair {
  View X, Bop, Aop;
};

// The pair's views: X (i, k), Bop (j, k) = B[j][k] or B[k][j], and Aop (i, k)
// = A[i][k] or A[k][i]. Set field by field: nvcc 12.9's cicc crashes on a
// braced return of conditional View temporaries.
__device__ __forceinline__ Pair pair_views(const float* A, const float* B, const float* x, int g, int Ma, int Mb,
                                           int trans) {
  Pair p;
  p.X.p = x + static_cast<size_t>(g) * Ma * Mb;
  p.X.sr = Mb, p.X.sc = 1, p.X.nr = Ma, p.X.nc = Mb;
  p.Bop.p = B + static_cast<size_t>(g) * Mb * Mb;
  p.Bop.sr = trans ? 1 : Mb, p.Bop.sc = trans ? Mb : 1, p.Bop.nr = Mb, p.Bop.nc = Mb;
  p.Aop.p = A + static_cast<size_t>(g) * Ma * Ma;
  p.Aop.sr = trans ? 1 : Ma, p.Aop.sc = trans ? Ma : 1, p.Aop.nr = Ma, p.Aop.nc = Ma;
  return p;
}

// Rows of the slab of T (and of staged Aop k) the cluster instance holds:
// the cluster's row tiles, rounded up to whole chunks.
__host__ __device__ constexpr int cluster_rows(int R, int TM) { return ceil_div(R * TM, kChunk) * kChunk; }

// Dynamic shared memory of each instance, in bytes.
template <int TM, int TN>
constexpr size_t cluster_smem(int R) {
  using G = Geo<TM, TN>;
  return sizeof(float) * (static_cast<size_t>(cluster_rows(R, TM)) * (TN + G::LDP) + G::kRed + G::kRing);
}

template <int TM, int TN>
constexpr size_t global_smem() {
  using G = Geo<TM, TN>;
  return sizeof(float) * (G::kRed + G::kRing);
}

template <int TM, int TN>
__global__ void __launch_bounds__(Geo<TM, TN>::kThreads, Geo<TM, TN>::kMinCtas)
kron_mv_cluster(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ x,
                float* __restrict__ y, int Ma, int Mb, int trans) {
  using G = Geo<TM, TN>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = gridDim.x, r = blockIdx.x;  // the cluster spans grid x: every row tile of this slab
  const int rows = cluster_rows(R, TM);
  float* Ts = smem;                                          // [rows][TN]: the slab of T
  float4* red = reinterpret_cast<float4*>(Ts + rows * TN);   // [kThreads]
  float* ring = reinterpret_cast<float*>(red + G::kThreads);  // the stage ring
  float* As = ring + G::kRing;                               // [rows][LDP]: Aop[this CTA's rows, :] as [k][i]
  const int i0 = r * TM, j0 = blockIdx.y * TN, g = blockIdx.z;
  const int s = threadIdx.x / G::kGroup, t = threadIdx.x % G::kGroup;
  const int i = i0 + 4 * (t / TN) + s, jj = t % TN;  // this thread's output: row i, column j0 + jj
  const Pair v = pair_views(A, B, x, g, Ma, Mb, trans);
  KRON_MARK(1);

  // Aop's rows for phase 3: one cp.async group, in flight through phase 1
  const int ka = ceil_div(Ma, kChunk);
  const Stager<TM, G::kThreads> sa(v.Aop, i0, G::LDP);
  for (int c = 0; c < ka; ++c) sa(As + c * kChunk * G::LDP, v.Aop, c * kChunk);
  cp_async_commit();
  // rows of T past the cluster's tiles that phase 3's last chunk reads
  for (int idx = R * TM * TN + threadIdx.x; idx < ka * kChunk * TN; idx += G::kThreads) Ts[idx] = 0.0f;

  // 1. this CTA's rows of the slab of T (rows past Ma are zero)
  const float tv = tile_product<TM, TN>(v.X, v.Bop, i0, j0, Mb, ring, red);
  KRON_MARK(2);
  Ts[i * TN + jj] = i < Ma ? tv : 0.0f;
  cluster.sync();  // every CTA's rows of T are in its shared memory
  KRON_MARK(3);

  // 2. the peers' rows (float4 idx of the slab lies in rank idx / kTile4's
  // rows): every load issued before the first store
  constexpr int kTile4 = TM * TN / 4, kCopies = ceil_div(kMaxCluster * kTile4, G::kThreads);
  float4 peer[kCopies];
#pragma unroll
  for (int e = 0; e < kCopies; ++e) {
    const int idx = threadIdx.x + e * G::kThreads, q = idx / kTile4;
    if (idx < R * kTile4 && q != r) peer[e] = reinterpret_cast<const float4*>(cluster.map_shared_rank(Ts, q))[idx];
  }
#pragma unroll
  for (int e = 0; e < kCopies; ++e) {
    const int idx = threadIdx.x + e * G::kThreads, q = idx / kTile4;
    if (idx < R * kTile4 && q != r) reinterpret_cast<float4*>(Ts)[idx] = peer[e];
  }
  KRON_MARK(4);
  cluster_arrive();  // done reading the peers' shared memory
  __syncthreads();   // the whole slab of T is in this CTA's shared memory

  // 3. Y[rows, slab] = Aop[rows, :] T[:, slab]
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < ka; ++c)
    fma_share<G::LDP, TN>(As + c * kChunk * G::LDP, Ts + c * kChunk * TN, s * kShare, t / TN, jj, acc);
  const float yv = reduce_groups<TM, TN>(acc, red);
  KRON_MARK(5);
  if (i < Ma && j0 + jj < Mb) y[static_cast<size_t>(g) * Ma * Mb + static_cast<size_t>(i) * Mb + j0 + jj] = yv;
  cluster_wait();  // no CTA leaves while a peer may still read its shared memory
  KRON_MARK(6);
}

template <int TM, int TN>
__global__ void __launch_bounds__(Geo<TM, TN>::kThreads, Geo<TM, TN>::kMinCtas)
kron_mv_global(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ x,
               float* __restrict__ y, float* __restrict__ scratch, int Ma, int Mb, int trans) {
  using G = Geo<TM, TN>;
  extern __shared__ __align__(16) float smem[];
  float4* red = reinterpret_cast<float4*>(smem);              // [kThreads]
  float* ring = reinterpret_cast<float*>(red + G::kThreads);  // the stage ring
  const int j0 = blockIdx.y * TN, g = blockIdx.z;
  const int s = threadIdx.x / G::kGroup, t = threadIdx.x % G::kGroup;
  const int di = 4 * (t / TN) + s, jj = t % TN;  // this thread's output within a tile
  const Pair v = pair_views(A, B, x, g, Ma, Mb, trans);
  // this CTA's slab of T, [Ma][TN], read by no other CTA
  float* T = scratch + (static_cast<size_t>(g) * gridDim.y + blockIdx.y) * Ma * TN;

  for (int i0 = 0; i0 < Ma; i0 += TM) {
    const float tv = tile_product<TM, TN>(v.X, v.Bop, i0, j0, Mb, ring, red);
    if (i0 + di < Ma) T[static_cast<size_t>(i0 + di) * TN + jj] = tv;
  }
  __syncthreads();  // the slab of T is written

  const View Tv{T, 1, TN, TN, Ma};  // (j, k) = T[k][j], j within the slab
  float* yg = y + static_cast<size_t>(g) * Ma * Mb;
  for (int i0 = 0; i0 < Ma; i0 += TM) {
    const float yv = tile_product<TM, TN>(v.Aop, Tv, i0, 0, Ma, ring, red);
    if (i0 + di < Ma && j0 + jj < Mb) yg[static_cast<size_t>(i0 + di) * Mb + j0 + jj] = yv;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// One launch at tile (TM, TN). The caller picks the instance: a null scratch
// takes the cluster instance, refused past the cluster's reach; a scratch
// buffer the global one. The grid, the cluster and the shared memory follow
// from the instance and the shape.
template <int TM, int TN>
cudaError_t launch(const float* A, const float* B, const float* x, float* y, float* scratch, int Ma, int Mb, int G,
                   int trans, cudaStream_t stream) {
  const int R = ceil_div(Ma, TM), slabs = ceil_div(Mb, TN);
  if (slabs > 65535) return cudaErrorInvalidValue;
  const dim3 block(Geo<TM, TN>::kThreads);
  if (scratch == nullptr) {
    if (R > kMaxCluster) return cudaErrorInvalidValue;
    const size_t smem = cluster_smem<TM, TN>(R);
    cudaError_t err = allow_smem(kron_mv_cluster<TM, TN>, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R, slabs, G);
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = R;  // the grid's x extent: one cluster a column slab
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kron_mv_cluster<TM, TN>, A, B, x, y, Ma, Mb, trans);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  const size_t smem = global_smem<TM, TN>();
  const cudaError_t err = allow_smem(kron_mv_global<TM, TN>, smem);
  if (err != cudaSuccess) return err;
  kron_mv_global<TM, TN><<<dim3(1, slabs, G), block, smem, stream>>>(A, B, x, y, scratch, Ma, Mb, trans);
  return cudaGetLastError();
}

}  // namespace

// y = (A ⊗ B) x (trans = 0) or (Aᵀ ⊗ Bᵀ) x (trans != 0) for G row-major
// pairs A (Ma, Ma), B (Mb, Mb), x and y (Ma * Mb), at the 16 × 16 tile. A
// null `scratch` takes the cluster instance (refused, cudaErrorInvalidValue,
// when ⌈Ma / 16⌉ > 8); otherwise `scratch` holds G * ⌈Mb / 16⌉ * Ma * 16
// floats and the global instance runs. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). The
// caller has made the tensors' device current.
extern "C" int zigp_kron_mv_f32(const void* A, const void* B, const void* x, void* y, void* scratch, int Ma, int Mb,
                                int G, int trans, void* stream) {
  if (Ma < 1 || Mb < 1 || G < 1 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<16, 16>(static_cast<const float*>(A), static_cast<const float*>(B),
                                         static_cast<const float*>(x), static_cast<float*>(y),
                                         static_cast<float*>(scratch), Ma, Mb, G, trans,
                                         static_cast<cudaStream_t>(stream)));
}
