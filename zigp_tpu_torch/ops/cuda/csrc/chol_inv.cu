// (L, L^-1) of a batch of small SPD float32 matrices, one CTA per matrix.
//
// Replaces zigp_tpu/ops/pallas/chol_inv.py:chol_inv_pallas (the Pallas TPU
// kernel, body _chol_inv_body). Same algorithm: a right-looking Cholesky
// interleaved with forward substitution on I, so that every later solve
// against the factor grams becomes a matmul against L^-1. The TPU kernel's
// masked-reduce "picks" and identity-tail padding to a multiple of 4 were
// Mosaic's constraints (no dynamic indexing of VMEM tiles); here A and L^-1
// sit in shared memory and are indexed directly, for any n <= 128.
//
// Bound on Hopper: latency. One matrix costs about 2n^3/3 flops (n^3/3 for
// the factor, n^3/3 for the triangular inverse) and moves 3n^2 * 4 bytes
// (K in, L and L^-1 out); at n <= 128 both are negligible against the card
// (67 TFLOP/s f32, 3.35 TB/s), so the time is set by the sequential chain of
// n column steps with two __syncthreads() each. With G = 2 (the f/g pair)
// the launch fills 2 of 132 SMs: packing more matrices per launch, or a
// shorter dependent chain (several columns per step), is the first thing a
// performance change should address.
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and division (the build
// uses no --use_fast_math). No pivot clamp: a non-PSD input gives NaN from
// the failing pivot on, as the reference kernel does.
//
// Layout: row-major (G, n, n) in and out. Shared memory holds A and B = L^-1
// with a row stride of n rounded up to an odd number, so the column reads
// A[k][j] of a warp (consecutive k) fall in distinct banks. At n = 128 that
// is 2 * 128 * 129 * 4 = 132,096 bytes, above the 48 KB default: the launch
// opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 128;

__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const float* __restrict__ K, float* __restrict__ L,
                float* __restrict__ Linv, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  float* A = smem;
  float* B = smem + n * ld;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  K += off;
  L += off;
  Linv += off;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    A[i * ld + k] = K[idx];
    B[i * ld + k] = (i == k) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // Every thread reads the pivot; A[j][j] is rewritten only after the
    // barrier below.
    const float piv = sqrtf(A[j * ld + j]);
    // Phase 1: column j of L below the diagonal, and row j of L^-1
    // (B[j][:j+1] already holds e_j - sum_{k<j} L[j][k] L^-1[k][:]).
    for (int i = j + 1 + tid; i < n; i += blockDim.x) A[i * ld + j] /= piv;
    for (int c = tid; c <= j; c += blockDim.x) B[j * ld + c] /= piv;
    __syncthreads();
    // Phase 2: rank-1 update of the trailing lower triangle, and the
    // forward-substitution update of the rows of L^-1 below j. One warp per
    // row, lanes across columns.
    if (tid == 0) A[j * ld + j] = piv;
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const float lij = A[i * ld + j];
      for (int k = j + 1 + lane; k <= i; k += 32)
        A[i * ld + k] = fmaf(-lij, A[k * ld + j], A[i * ld + k]);
      for (int c = lane; c <= j; c += 32)
        B[i * ld + c] = fmaf(-lij, B[j * ld + c], B[i * ld + c]);
    }
    __syncthreads();
  }

  // Lower triangles out; the upper triangles are written as zeros.
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    const bool lower = k <= i;
    L[idx] = lower ? A[i * ld + k] : 0.0f;
    Linv[idx] = lower ? B[i * ld + k] : 0.0f;
  }
}

}  // namespace

// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success): a refused launch never runs, and only this
// code reports it. The caller has made the tensors' device current.
extern "C" int zigp_chol_inv_f32(const void* K, void* L, void* Linv, int n,
                                 int G, void* stream) {
  if (n < 1 || n > kMaxN || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = n | 1;
  const size_t smem = 2 * static_cast<size_t>(n) * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(K), static_cast<float*>(L),
      static_cast<float*>(Linv), n);
  return static_cast<int>(cudaGetLastError());
}
