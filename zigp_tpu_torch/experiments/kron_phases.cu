// Where kron_mv.cu's cluster instance spends its time, at each tile swept:
// the kernel itself, included with KRON_MARK defined so that thread 0 of
// every CTA records clock64() at the phase boundaries, the global timer at
// its start and end, and its SM. The library builds the 16 × 16 tile only;
// this build instantiates every tile of the sweep. Built and driven by
// kron_phases.py.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCtas = 4096;
constexpr int kMarks = 10;  // 0 start ns, 1-6 clock64 at marks 1-6, 7 end ns, 8 SM
__device__ unsigned long long g_marks[kMaxCtas][kMarks];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void kron_mark(int k) {
  if (threadIdx.x != 0) return;
  const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (cta >= kMaxCtas) return;
  if (k == 1) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_marks[cta][0] = global_ns();
    g_marks[cta][8] = sm;
  }
  g_marks[cta][k] = clock64();
  if (k == 6) g_marks[cta][7] = global_ns();
}

}  // namespace

#define KRON_MARK(k) kron_mark(k)
#include "../ops/cuda/csrc/kron_mv.cu"

// zigp_kron_mv_f32's cluster instance (null scratch) at tile (tm, tn), one
// of (16, 16), (16, 32), (16, 64), (32, 32); any other tile is refused.
extern "C" int zigp_kron_phases_f32(const void* A, const void* B, const void* x, void* y, int Ma, int Mb, int G,
                                    int trans, int tm, int tn, void* stream) {
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(B);
  const auto* v = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tm == 16 && tn == 16) err = launch<16, 16>(a, b, v, out, nullptr, Ma, Mb, G, trans, st);
  if (tm == 16 && tn == 32) err = launch<16, 32>(a, b, v, out, nullptr, Ma, Mb, G, trans, st);
  if (tm == 16 && tn == 64) err = launch<16, 64>(a, b, v, out, nullptr, Ma, Mb, G, trans, st);
  if (tm == 32 && tn == 32) err = launch<32, 32>(a, b, v, out, nullptr, Ma, Mb, G, trans, st);
  return static_cast<int>(err);
}

// Copies the marks of the last launch (kMaxCtas × kMarks u64) to host `dst`.
extern "C" int zigp_kron_marks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks)));
}
