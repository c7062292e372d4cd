// L = chol(K) of a batch of SPD float32 matrices, one CTA per matrix, R
// columns per step.
//
// Replaces zigp_tpu/ops/pallas/cholesky.py:small_cholesky and
// batched_small_cholesky (R = 1: one column per step, _chol_body) and
// zigp_tpu/ops/pallas/chol_inv.py:chol_pallas (R = rank: the L-only body
// _chol_body that finalises `rank` columns per iteration). Unlike
// chol_inv.cu it carries no L^-1, so it does half the work.
//
// One step at column j0 handles r = min(R, n - j0) columns:
//   1. The panel, by warp 0 alone (only __syncwarp between its columns): for
//      each column j of the step, first absorb the updates of the step's
//      earlier columns, A[i][j] -= sum_{e=j0}^{j-1} L[i][e] L[j][e] for
//      i >= j (the inline `u = u - v[e] * l[(c, e)]` of the TPU body), then
//      take the pivot sqrt(A[j][j]) and scale the column below it.
//   2. The trailing lower triangle, by the whole CTA: A[i][k] -= sum_c
//      L[i][j0+c] L[k][j0+c] for j0 + r <= k <= i, the r rank-1 updates fused
//      into one pass. One warp per row, lanes across columns.
// So a step costs one __syncthreads() pair for r columns, where the
// one-column form (R = 1, and chol_inv.cu) pays one pair per column.
//
// Bound on Hopper: latency. One matrix is n^3/3 flops and 2n^2 * 4 bytes (K
// in, L out); at the paths' n <= 250 both are far below the card's 67
// TFLOP/s f32 and 3.35 TB/s, so the time is set by the chain of steps and
// their barriers; with G = 2 the launch fills 2 of 132 SMs. R trades
// barriers against the panel's serial work on one warp.
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and division (no
// --use_fast_math). No pivot clamp: a non-PSD input gives NaN from the
// failing pivot on, and the rows before it are left as they are. The upper
// triangle of L is written as zeros.
//
// Memory: the matrix sits in shared memory with a row stride of n rounded up
// to an odd number (column reads of a warp fall in distinct banks), opted in
// past 48 KB, while n * (n|1) * 4 bytes fits the device's opt-in limit
// (n <= 241 on an H100). Above that, the same code works in place on L in
// global memory (row stride n); __syncthreads() orders those accesses within
// the CTA as it does for shared memory. No identity-tail padding: any n >= 1
// and any R >= 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// R columns per step: a compile-time kR (1, 2, 4, 8) keeps the row's panel
// entries in registers; kR = 0 takes R at run time and reads them from A.
template <int kR>
__device__ __forceinline__ void chol_steps(float* A, int ld, int n, int R) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (kR > 0) R = kR;

  for (int j0 = 0; j0 < n; j0 += R) {
    const int r = min(R, n - j0);
    if (warp == 0) {
      for (int c = 0; c < r; ++c) {
        const int j = j0 + c;
        for (int i = j + lane; i < n; i += 32) {
          float a = A[i * ld + j];
          for (int e = j0; e < j; ++e) a = fmaf(-A[i * ld + e], A[j * ld + e], a);
          A[i * ld + j] = a;
        }
        __syncwarp();
        const float piv = sqrtf(A[j * ld + j]);
        __syncwarp();  // every lane has read the pivot before lane 0 rewrites it
        for (int i = j + 1 + lane; i < n; i += 32) A[i * ld + j] /= piv;
        if (lane == 0) A[j * ld + j] = piv;
        __syncwarp();
      }
    }
    __syncthreads();
    const int t0 = j0 + r;
    for (int i = t0 + warp; i < n; i += nwarps) {
      if constexpr (kR > 0) {
        float li[kR];
#pragma unroll
        for (int c = 0; c < kR; ++c) li[c] = c < r ? A[i * ld + j0 + c] : 0.0f;
        for (int k = t0 + lane; k <= i; k += 32) {
          float a = A[i * ld + k];
#pragma unroll
          for (int c = 0; c < kR; ++c)
            if (c < r) a = fmaf(-li[c], A[k * ld + j0 + c], a);
          A[i * ld + k] = a;
        }
      } else {
        for (int k = t0 + lane; k <= i; k += 32) {
          float a = A[i * ld + k];
          for (int c = 0; c < r; ++c) a = fmaf(-A[i * ld + j0 + c], A[k * ld + j0 + c], a);
          A[i * ld + k] = a;
        }
      }
    }
    __syncthreads();
  }
}

template <int kR, bool kShared>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const float* __restrict__ K, float* __restrict__ L, int n, int R) {
  extern __shared__ float smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  K += off;
  L += off;
  const int ld = kShared ? (n | 1) : n;
  float* A = kShared ? smem : L;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    A[i * ld + (idx - i * n)] = K[idx];
  }
  __syncthreads();
  chol_steps<kR>(A, ld, n, R);

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    if (kShared)
      L[idx] = k <= i ? A[i * ld + k] : 0.0f;
    else if (k > i)
      L[idx] = 0.0f;
  }
}

size_t shared_bytes(int n) { return static_cast<size_t>(n) * (n | 1) * sizeof(float); }

size_t optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return static_cast<size_t>(bytes);
}

template <int kR>
cudaError_t launch(const float* K, float* L, int n, int G, int R, cudaStream_t stream) {
  const size_t smem = shared_bytes(n);
  if (smem <= optin_limit()) {
    cudaError_t err = cudaFuncSetAttribute(chol_kernel<kR, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    chol_kernel<kR, true><<<G, kThreads, smem, stream>>>(K, L, n, R);
  } else {
    chol_kernel<kR, false><<<G, kThreads, 0, stream>>>(K, L, n, R);
  }
  return cudaGetLastError();
}

}  // namespace

// The largest n the shared-memory instance takes on the current device;
// above it the kernel works in place on L in global memory.
extern "C" int zigp_chol_shared_max_n() {
  const size_t limit = optin_limit();
  int n = 1;
  while (shared_bytes(n + 1) <= limit) ++n;
  return n;
}

// L = chol(K) for G row-major (n, n) matrices, R columns per step. Launches
// on `stream` without synchronising and returns the launch's cudaError_t (0
// on success). The caller has made the tensors' device current.
extern "C" int zigp_chol_f32(const void* K, void* L, int n, int G, int R, void* stream) {
  if (n < 1 || G < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const float*>(K);
  auto* l = static_cast<float*>(L);
  auto s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return static_cast<int>(launch<1>(k, l, n, G, R, s));
    case 2: return static_cast<int>(launch<2>(k, l, n, G, R, s));
    case 4: return static_cast<int>(launch<4>(k, l, n, G, R, s));
    case 8: return static_cast<int>(launch<8>(k, l, n, G, R, s));
    default: return static_cast<int>(launch<0>(k, l, n, G, R, s));
  }
}
