// y = (A ⊗ B) x, or (Aᵀ ⊗ Bᵀ) x, for a batch of G pairs of square float32
// factors.
//
// Replaces zigp_tpu/ops/pallas/kron_matvec.py:kron_mv_2 (the Pallas TPU
// kernel _kron_mv_kernel). Same contraction: x of one pair is X (Ma, Mb),
// row-major (i_a, i_b); T = X Bᵀ, then Y = A T, y = vec(Y) row-major. The
// TPU kernel keeps the (Ma, Mb) intermediate T in VMEM. Here the work of one
// pair is cut by columns of T and Y: column j of T needs row j of B and all
// of X, and column j of Y needs A and column j of T only. So CTA (c, g)
// owns 32 columns [32c, 32c + 32) and computes its slab of T straight into
// shared memory (no other CTA needs it), then writes its slab of Y; no
// intermediate goes through device memory and no CTA waits on another. A
// slab is Ma * 32 * 4 bytes (13 KB at Ma = 105); where that exceeds the
// device's opt-in shared memory (Ma above about 1,700) the slab goes to a
// global scratch buffer of G * Ma * Mb floats instead.
//
// The transposed product (Aᵀ ⊗ Bᵀ) x = vec(Aᵀ X B), which the serving path
// needs for the L⁻ᵀ pass of the unwhitened mean, reads A and B transposed
// (`trans` != 0); no transposed copies are made.
//
// Threads: lanes across the slab's 32 columns, warps across rows of X and
// A. Phase 1 walks Mb in chunks of 32, staging the chunk of B's slab rows in
// shared memory (stride 33, conflict-free), with X[i][k] a warp-wide
// broadcast. Phase 2 reads A[i][k] as a broadcast and T[k][lane] from the
// slab (consecutive lanes, distinct banks). Plain f32 FMAs, accumulated in
// the order of k, so no TF32 can arise.
//
// Bound on Hopper: 2 G Ma Mb (Ma + Mb) flops against (Ma² + Mb² + 2 Ma Mb)
// * 4 bytes per pair: at the serving path's (2; 105, 250) 37 MFLOP, 0.56 µs
// at 67 TFLOP/s; at (2; 10, 100) the launch itself. CUDA-core FMAs from
// shared memory reach a fraction of that; wgmma would need a tiling this
// first version does not have.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;  // columns of T and Y per CTA: one per lane
constexpr int kChunk = 32;  // rows of the B slab staged per pass over Mb

template <bool kSharedT>
__global__ void __launch_bounds__(kThreads)
kron_mv_kernel(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ x, float* __restrict__ y,
               float* __restrict__ scratch, int Ma, int Mb, int trans) {
  extern __shared__ float smem[];
  float* Bs = smem;                         // [kCols][kChunk + 1]
  float* Ts = smem + kCols * (kChunk + 1);  // [Ma][kCols], shared instance only
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j = j0 + lane;
  const bool col = j < Mb;

  A += static_cast<size_t>(g) * Ma * Ma;
  B += static_cast<size_t>(g) * Mb * Mb;
  const size_t off = static_cast<size_t>(g) * Ma * Mb;
  x += off;
  y += off;
  // T[i][lane] of this slab: shared slab, or row i of the pair's scratch T.
  auto t_at = [&](int i) -> float& {
    if constexpr (kSharedT) return Ts[i * kCols + lane];
    else return scratch[off + static_cast<size_t>(i) * Mb + j];
  };

  for (int i = warp; i < Ma; i += nwarps)
    if (col) t_at(i) = 0.0f;

  // Phase 1: T[:, slab] = X Bop[slab, :]ᵀ, Bop = B, or Bᵀ when transposed.
  for (int k0 = 0; k0 < Mb; k0 += kChunk) {
    const int kc = min(kChunk, Mb - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < kCols * kChunk; idx += blockDim.x) {
      const int c = idx / kChunk;
      const int kk = idx - c * kChunk;
      const int jj = j0 + c, k = k0 + kk;
      float v = 0.0f;
      if (jj < Mb && kk < kc) v = trans ? B[static_cast<size_t>(k) * Mb + jj] : B[static_cast<size_t>(jj) * Mb + k];
      Bs[c * (kChunk + 1) + kk] = v;
    }
    __syncthreads();
    if (!col) continue;
    for (int i = warp; i < Ma; i += nwarps) {
      const float* xi = x + static_cast<size_t>(i) * Mb + k0;
      float acc = t_at(i);
      for (int kk = 0; kk < kc; ++kk) acc = fmaf(xi[kk], Bs[lane * (kChunk + 1) + kk], acc);
      t_at(i) = acc;
    }
  }
  __syncthreads();  // the slab of T is complete

  // Phase 2: Y[:, slab] = Aop T[:, slab], Aop = A, or Aᵀ when transposed.
  if (!col) return;
  for (int i = warp; i < Ma; i += nwarps) {
    float acc = 0.0f;
    for (int k = 0; k < Ma; ++k) {
      const float a = trans ? A[static_cast<size_t>(k) * Ma + i] : A[static_cast<size_t>(i) * Ma + k];
      acc = fmaf(a, t_at(k), acc);
    }
    y[static_cast<size_t>(i) * Mb + j] = acc;
  }
}

size_t optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return static_cast<size_t>(bytes);
}

size_t b_bytes() { return kCols * (kChunk + 1) * sizeof(float); }
size_t t_bytes(int Ma) { return static_cast<size_t>(Ma) * kCols * sizeof(float); }

}  // namespace

// 1 if the slab of T for factors of Ma rows fits in shared memory on the
// current device, 0 if the kernel needs the global scratch of G * Ma * Mb
// floats.
extern "C" int zigp_kron_mv_shared_t(int Ma) { return b_bytes() + t_bytes(Ma) <= optin_limit() ? 1 : 0; }

// y = (A ⊗ B) x (trans = 0) or (Aᵀ ⊗ Bᵀ) x (trans != 0) for G row-major
// pairs A (Ma, Ma), B (Mb, Mb), x and y (Ma * Mb). `scratch` holds G * Ma * Mb
// floats when zigp_kron_mv_shared_t(Ma) is 0 and may be null otherwise.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t (0 on success). The caller has made the tensors' device current.
extern "C" int zigp_kron_mv_f32(const void* A, const void* B, const void* x, void* y, void* scratch,
                                int Ma, int Mb, int G, int trans, void* stream) {
  if (Ma < 1 || Mb < 1 || G < 1 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Mb + kCols - 1) / kCols, G);
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(B);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto* s = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (zigp_kron_mv_shared_t(Ma)) {
    const size_t smem = b_bytes() + t_bytes(Ma);
    cudaError_t err = cudaFuncSetAttribute(kron_mv_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kron_mv_kernel<true><<<grid, kThreads, smem, st>>>(a, b, xv, yv, s, Ma, Mb, trans);
  } else {
    if (s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    kron_mv_kernel<false><<<grid, kThreads, b_bytes(), st>>>(a, b, xv, yv, s, Ma, Mb, trans);
  }
  return static_cast<int>(cudaGetLastError());
}
