// Where bf16x3_mm.cu's tile instance spends a chunk of k: the kernel itself, included with BF16X3_MARK defined so
// that the first thread of each warpgroup of the grid's first CTA records clock64() at the tile loop's marks
// (0 the chunk's start, 1 its stage landed, 2 split, 3 the products two chunks back done, 4 the block barrier,
// 5 the products started, 6 the next copies started). Built and driven by bf16x3_phases.py.

#include <cuda_runtime.h>

namespace {

constexpr int kMarkChunks = 64;
constexpr int kMarks = 8;
__device__ long long g_marks[2][kMarkChunks][kMarks];

__device__ __forceinline__ void bf16x3_mark(int k, int c) {
  if (threadIdx.x % 128 != 0 || blockIdx.x != 0 || blockIdx.y != 0 || c >= kMarkChunks) return;
  g_marks[threadIdx.x / 128][c][k] = clock64();
}

}  // namespace

#define BF16X3_MARK(k, c) bf16x3_mark(k, c)
#include "../ops/cuda/csrc/bf16x3_mm.cu"

// The marks of the last launch, [warpgroup][chunk][mark], into `out` (2 * 64 * 8 int64).
extern "C" int zigp_bf16x3_marks(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)));
}
