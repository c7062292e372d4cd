// The ARD RBF cross-gram of a batch of G kernels, float32:
//
//   K[g, i, j] = var[g] * exp(-1/2 * sum_d (X[g,i,d] - Z[g,j,d])^2 / ell[g,d]^2)
//
// Replaces zigp_tpu/ops/pallas/rbf_gram.py:rbf_gram (the Pallas TPU kernel,
// body _gram_kernel), which takes any input dimension D. Same arithmetic:
// the exact difference form, never the expansion |x|^2 - 2 x.z + |z|^2,
// which cancels catastrophically in float32 at the pptr time column
// (t ~ 5, ell ~ 0.005). D = 1, 2 and 3 (the spatial and temporal factors)
// are unrolled with Z's row and 1/ell^2 in registers; any other D (a
// covariate factor) takes the same loop with D read at run time and Z's row
// and ell read from L1 in the inner loop. The TPU kernel's 256 x 256 VMEM
// tiles and its padding of N and M were Mosaic's constraints; here each
// thread writes its own entries and masks the ragged edge.
//
// Bound on Hopper: writing K. Per entry it reads nothing new (X and Z rows
// are a few floats, served from L1) and writes 4 bytes after about 3D + 3
// flops and one expf, so the least time is G*N*M*4 bytes over 3.35 TB/s:
// 0.24 us for the largest flagship gram (2, 100, 1000), below the cost of a
// launch, which is what bounds the kernel at these sizes. The design keeps
// the store coalesced: threadIdx.x runs along j, the contiguous dimension of
// K, and a block covers 32 columns by 32 rows (8 rows of threads, 4 rows
// each), with blockIdx.z = g.
//
// Strides: X and Z are row-major (N, D) and (M, D) blocks, one per g, at a
// distance of x_gstride and z_gstride floats; a stride of 0 shares one block
// across the batch (the minibatch x_p, used by both GPs of the pair, is not
// copied). ell is (G, D) and var is (G,), both contiguous; K is (G, N, M).
//
// Numerics: IEEE expf and division (the build uses no --use_fast_math).

#include <cuda_runtime.h>

namespace {

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
    for (int d = 0; d < D; ++d) {
      const float diff = X[static_cast<size_t>(i) * D + d] - z[d];
      acc += diff * diff * inv_ell2[d];
    }
    K[static_cast<size_t>(i) * M + j] = v * expf(-0.5f * acc);
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
      const float diff = x[d] - Z[d];
      acc += diff * diff * (1.0f / (l * l));
    }
    K[static_cast<size_t>(i) * M + j] = v * expf(-0.5f * acc);
  }
}

dim3 grid_of(int G, int N, int M) {
  return dim3((M + kTileJ - 1) / kTileJ, (N + kTileI * kRows - 1) / (kTileI * kRows), G);
}

template <int D>
cudaError_t launch(const float* X, const float* Z, const float* ell,
                   const float* var, float* K, int G, int N, int M,
                   long long xg, long long zg, cudaStream_t stream) {
  rbf_gram_kernel<D><<<grid_of(G, N, M), dim3(kTileJ, kTileI), 0, stream>>>(X, Z, ell, var, K, N, M, xg, zg);
  return cudaGetLastError();
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
