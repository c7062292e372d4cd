// (L, L^-1) of a batch of small SPD float32 matrices, one CTA per matrix.
//
// Replaces the TPU kernel of zigp_tpu's ops/.../chol_inv.py whose body is
// _chol_inv_body (file and line in PERF.md's kernel table): a right-looking
// Cholesky with the forward substitution on I carried along, so that every later solve against the
// factor grams becomes a matmul against L^-1. The TPU kernel's masked-reduce
// "picks" and identity-tail padding were Mosaic's constraints; here the
// factorization is chol_tile.cuh's blocked, register-tiled one (NB columns a
// step, the next diagonal block factored on warp 0 while the other warps
// update the trailing matrix, the panel and the block row of L^-1 by forward
// substitution, the trailing update in 4 x 4 register micro-tiles), for any
// 1 <= n <= the largest n whose two triangles fit the device's shared
// memory (238 on an H100).
//
// Bound on Hopper: latency. One matrix costs about 2n^3/3 flops (n^3/3 for
// the factor, n^3/3 for the triangular inverse) and moves 3n^2 * 4 bytes (K
// in, L and L^-1 out); at n <= 238 both are far below the card (67 TFLOP/s
// f32, 3.35 TB/s) and the work fits one SM in a few microseconds, so the
// time is set by the dependent chain: per column an IEEE sqrtf and an IEEE
// reciprocal on warp 0, overlapped with the trailing update, and per block
// step two __syncthreads() (26 at n = 100 with NB = 8, where the one-column
// form took 200). With G = 2 (the f/g pair) the launch fills 2 of 132 SMs;
// a matrix this small cannot be spread across SMs without paying more in
// synchronisation than it saves.
//
// Not used, on purpose: wgmma and TMA (the matrix is loaded once, and the
// trailing products are at most 238 x 238 x NB, too small to amortise a
// warpgroup pipeline), TF32 (f32 products that replace solves stay full
// f32, the repository's rule), FP64 tensor cores (the path is float32).
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and reciprocal (no
// --use_fast_math), no pivot clamp: a non-PSD input gives NaN from the
// failing pivot on, the rows before it as they were. L takes the operations
// of chol_plain(K, rank=NB) and L^-1 those of chol_inv_plain(K, nb=NB), in
// their order, with a multiply by the pivot's reciprocal where the plain
// versions divide.
//
// Memory: A and B = L^-1 as row-padded lower triangles in shared memory
// (chol_tile.cuh), 2 * padded_floats(n) * 4 bytes and 64 for the pivots'
// reciprocals, opted in past 48 KB: 232,352 bytes at n = 238 within the
// H100's 232,448. K is read with
// 16-byte loads where n % 4 == 0 and the pointers are aligned; L and L^-1
// are written whole, the upper triangles as zeros, in the same way.

#include "chol_tile.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(zigp::kTileThreads)
chol_inv_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv, int n, bool vec) {
  extern __shared__ float smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const zigp::Packed A{smem}, B{smem + zigp::padded_floats(n)};

  zigp::load_lower(K + off, A, n, vec);
  zigp::identity_lower(B, n);
  __syncthreads();
  zigp::chol_blocked<NB, true>(A, B, n, smem + 2 * zigp::padded_floats(n));
  zigp::store_lower(A, L + off, n, vec);
  zigp::store_lower(B, Linv + off, n, vec);
}

// A, B = L^-1 and the block's pivot reciprocals.
size_t shared_bytes(int n) { return (2 * zigp::padded_floats(n) + zigp::kMaxNB) * sizeof(float); }

template <int NB>
cudaError_t launch(const float* K, float* L, float* Linv, int n, int G, cudaStream_t stream) {
  const size_t smem = shared_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(chol_inv_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && zigp::aligned16(K) && zigp::aligned16(L) && zigp::aligned16(Linv);
  chol_inv_kernel<NB><<<G, zigp::kTileThreads, smem, stream>>>(K, L, Linv, n, vec);
  return cudaGetLastError();
}

}  // namespace

// The largest n the kernel takes on the current device: A and L^-1 of one
// matrix within its opt-in shared memory.
extern "C" int zigp_chol_inv_max_n() {
  const size_t limit = static_cast<size_t>(zigp::optin_limit());
  int n = 0;
  while (shared_bytes(n + 1) <= limit) ++n;
  return n;
}

// (L, L^-1) for G row-major (n, n) matrices, nb (4, 8 or 16) columns a
// block step. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success): a refused launch never runs, and only
// this code reports it. The caller has made the tensors' device current.
extern "C" int zigp_chol_inv_f32(const void* K, void* L, void* Linv, int n, int G, int nb, void* stream) {
  if (n < 1 || G < 1 || shared_bytes(n) > static_cast<size_t>(zigp::optin_limit()))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const float*>(K);
  auto* l = static_cast<float*>(L);
  auto* li = static_cast<float*>(Linv);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 4: return static_cast<int>(launch<4>(k, l, li, n, G, s));
    case 8: return static_cast<int>(launch<8>(k, l, li, n, G, s));
    case 16: return static_cast<int>(launch<16>(k, l, li, n, G, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
