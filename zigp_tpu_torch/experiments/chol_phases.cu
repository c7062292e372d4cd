// Where the tiled Cholesky's time goes: chol_tile.cuh's chol_blocked, the
// code chol.cu and chol_inv.cu run, with phase marks that read clock64() in
// thread 0 at the phases of every block step. Built and driven by
// chol_phases.py.
//
// The marks after P and U follow the kernels' own barriers; the lookahead's
// is warp 0's alone.
//
// Also the cluster kernel (chol_inv_cluster.cu, included whole) with marks
// at its phases, read by threads 0 and 32 of every CTA.

#include "../ops/cuda/csrc/chol_tile.cuh"
#include "../ops/cuda/csrc/chol_inv_cluster.cu"

namespace {

// cycles[1..3], summed over the steps: the panel (with L_jj's broadcast),
// the rest of the trailing update after warp 0's lookahead, and warp 0's
// lookahead (the next block's tiles and factor); cycles[4]: the last mark;
// cycles[5]: load (K into shared memory, and B = I); cycles[6]: store. The
// first block's factor, before the loop, counts as the first panel. Thread
// 0, in warp 0, reads the clock.
struct ClockMarks {
  long long* cycles;
  __device__ void operator()(int phase) const {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      cycles[phase] += t - cycles[4];
      cycles[4] = t;
    }
  }
};

template <int NB, bool kInv>
__global__ void __launch_bounds__(zigp::kTileThreads)
phases_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv, int n,
              long long* cycles) {
  extern __shared__ float smem[];
  const zigp::Packed A{smem}, B{smem + zigp::padded_floats(n)};
  long long t0 = clock64();
  zigp::load_lower(K, A, n, false);
  if (kInv) zigp::identity_lower(B, n);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < 4; ++p) cycles[p] = 0;
    cycles[4] = clock64();
    cycles[5] = cycles[4] - t0;
  }
  zigp::chol_blocked<NB, kInv>(A, B, n, smem + (kInv ? 2 : 1) * zigp::padded_floats(n), ClockMarks{cycles});
  t0 = clock64();
  zigp::store_lower(A, L, n, false);
  if (kInv) zigp::store_lower(B, Linv, n, false);
  __syncthreads();
  if (threadIdx.x == 0) cycles[6] = clock64() - t0;
}

template <int NB, bool kInv>
int launch(const float* K, float* L, float* Linv, int n, long long* cycles) {
  const size_t smem = ((kInv ? 2 : 1) * zigp::padded_floats(n) + zigp::kMaxNB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(phases_kernel<NB, kInv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  phases_kernel<NB, kInv><<<1, zigp::kTileThreads, smem>>>(K, L, Linv, n, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One matrix, n x n row-major, on the default stream; with inv, L^-1 too.
// Returns the launch's cudaError_t (0 on success).
extern "C" int zigp_chol_phases(const void* K, void* L, void* Linv, int n, int nb, int inv, void* cycles) {
  const auto* k = static_cast<const float*>(K);
  auto* l = static_cast<float*>(L);
  auto* li = static_cast<float*>(Linv);
  auto* c = static_cast<long long*>(cycles);
  switch (nb) {
    case 4: return inv ? launch<4, true>(k, l, li, n, c) : launch<4, false>(k, l, li, n, c);
    case 8: return inv ? launch<8, true>(k, l, li, n, c) : launch<8, false>(k, l, li, n, c);
    case 16: return inv ? launch<16, true>(k, l, li, n, c) : launch<16, false>(k, l, li, n, c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// Cycles of the cluster kernel by phase, summed over the steps, for threads
// 0 (warp 0: the chain on the owner of the next diagonal block) and 32 (warp
// 1: never the chain) of every CTA: cycles[(cta * 2 + thread 32) * 8 + k],
// k = 1 the wait for L_jj, 2 the panel, 3 the wait for the staged panel, 4
// the update with the step's closing barrier, 5 the chain (the next block's
// tiles, its factor and the push), 6 the load and the first block's factor,
// 7 the store; slot 0 holds the last reading.
struct ClusterClock {
  long long* cycles;
  __device__ void operator()(int phase) const {
    if (threadIdx.x != 0 && threadIdx.x != 32) return;
    long long* c = cycles + (blockIdx.x * 2 + (threadIdx.x == 32)) * 8;
    const long long t = clock64();
    if (phase == 0) {
      for (int k = 1; k < 8; ++k) c[k] = 0;
    } else {
      c[phase] += t - c[0];
    }
    c[0] = t;
  }
};

}  // namespace

// G matrices, n x n row-major, in clusters of C CTAs on the default stream,
// with the phase marks into `cycles` (G * C * 16 long longs). Returns the
// launch's cudaError_t (0 on success).
extern "C" int zigp_chol_cluster_phases(const void* K, void* L, void* Linv, int n, int G, int C, void* cycles) {
  return static_cast<int>(zigp_cluster::launch_cluster(static_cast<const float*>(K), static_cast<float*>(L),
                                                       static_cast<float*>(Linv), n, G, C, nullptr,
                                                       ClusterClock{static_cast<long long*>(cycles)}));
}
