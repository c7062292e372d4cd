// L = chol(K) of a batch of SPD float32 matrices, one CTA per matrix.
//
// Replaces three TPU kernels of zigp_tpu (file and line in PERF.md's kernel
// table): small_cholesky and batched_small_cholesky (one column a step, body
// _chol_body of ops/.../cholesky.py) and the L-only kernel beside chol_inv
// (`rank` columns a step, body _chol_body of ops/.../chol_inv.py). All three
// run chol_tile.cuh's blocked, register-tiled factorization at one panel
// width NB, whatever their column count: the next diagonal block factored
// on warp 0 while the other warps update the trailing matrix, the panel by
// forward substitution, the trailing update in 4 x 4 register micro-tiles.
// Unlike chol_inv.cu it carries no L^-1, so it does half the work.
//
// Bound on Hopper: latency. One matrix is n^3/3 flops and 2n^2 * 4 bytes (K
// in, L out); at the paths' n <= 250 both are far below the card's 67
// TFLOP/s f32 and 3.35 TB/s and the work fits one SM in a few microseconds,
// so the time is set by the dependent chain: per column an IEEE sqrtf and
// an IEEE reciprocal on warp 0, overlapped with the trailing update, and two
// __syncthreads() per block step (26 at n = 100 with NB = 8). With G = 2
// the launch fills 2 of 132 SMs, with one matrix 1 of 132; spreading one
// small matrix across SMs would cost more synchronisation than it saves.
//
// Not used, on purpose: wgmma and TMA (the matrix is loaded once and the
// trailing products are at most n x n x NB, too small for a warpgroup
// pipeline), TF32 (full f32, the repository's rule), FP64 tensor cores (the
// path is float32).
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and reciprocal (no
// --use_fast_math), no pivot clamp: a non-PSD input gives NaN from the
// failing pivot on, the rows before it as they were; the upper triangle of
// L is written as zeros. The operations are those of chol_plain(K,
// rank=NB), in their order, with a multiply by the pivot's reciprocal where
// the plain version divides.
//
// Memory: the lower triangle, row-padded (chol_tile.cuh), in shared memory,
// padded_floats(n) * 4 bytes, opted in past 48 KB, while it fits the
// device's opt-in limit (n <= 337 on an H100). Above that, the same tiled
// code works in place on L in global memory (row stride n);
// __syncthreads() orders those accesses within the CTA as it does shared
// memory. K is read, and L written, with 16-byte accesses where n % 4 == 0
// and the pointers are aligned.

#include "chol_tile.cuh"

namespace {

template <int NB, bool kShared>
__global__ void __launch_bounds__(zigp::kTileThreads)
chol_kernel(const float* __restrict__ K, float* __restrict__ L, int n, bool vec) {
  extern __shared__ float smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  K += off;
  L += off;
  if constexpr (kShared) {
    const zigp::Packed A{smem};
    zigp::load_lower(K, A, n, vec);
    __syncthreads();
    zigp::chol_blocked<NB, false>(A, A, n, smem + zigp::padded_floats(n));
    zigp::store_lower(A, L, n, vec);
  } else {
    const zigp::Square A{L, n};
    zigp::load_lower(K, A, n, vec);
    __syncthreads();
    zigp::chol_blocked<NB, false>(A, A, n, smem);
    for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5)
      for (int k = i + 1 + (threadIdx.x & 31); k < n; k += 32) A(i, k) = 0.0f;
  }
}

// A and the block's pivot reciprocals; the global-memory instance takes only the latter.
size_t shared_bytes(int n) { return (zigp::padded_floats(n) + zigp::kMaxNB) * sizeof(float); }

template <int NB>
cudaError_t launch(const float* K, float* L, int n, int G, cudaStream_t stream) {
  const size_t smem = shared_bytes(n);
  const bool vec = n % 4 == 0 && zigp::aligned16(K) && zigp::aligned16(L);
  if (smem <= static_cast<size_t>(zigp::optin_limit())) {
    cudaError_t err = cudaFuncSetAttribute(chol_kernel<NB, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    chol_kernel<NB, true><<<G, zigp::kTileThreads, smem, stream>>>(K, L, n, vec);
  } else {
    chol_kernel<NB, false><<<G, zigp::kTileThreads, zigp::kMaxNB * sizeof(float), stream>>>(K, L, n, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// The largest n the shared-memory instance takes on the current device;
// above it the kernel works in place on L in global memory.
extern "C" int zigp_chol_shared_max_n() {
  const size_t limit = static_cast<size_t>(zigp::optin_limit());
  int n = 0;
  while (shared_bytes(n + 1) <= limit) ++n;
  return n;
}

// L = chol(K) for G row-major (n, n) matrices, nb (4, 8 or 16) columns a
// block step. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success). The caller has made the tensors'
// device current.
extern "C" int zigp_chol_f32(const void* K, void* L, int n, int G, int nb, void* stream) {
  if (n < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const float*>(K);
  auto* l = static_cast<float*>(L);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 4: return static_cast<int>(launch<4>(k, l, n, G, s));
    case 8: return static_cast<int>(launch<8>(k, l, n, G, s));
    case 16: return static_cast<int>(launch<16>(k, l, n, G, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
