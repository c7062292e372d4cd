// C[g] = op(A[g]) op(B[g]) for a batch of float32 operands, in the three
// bf16 products of the TPU's Precision.HIGH ("bf16_3x").
//
// Replaces no Pallas kernel. It replaces XLA's Precision.HIGH dot on the
// TPU's MXU, which zigp_tpu/ops/linalg.py:56-118 selects for every
// solve-replacing product under set_solve_precision("high" | "mixed")
// (hdot, bdot, bulk_precision() and the chol_inv VJP's products). PyTorch
// has no call for it: a bf16 torch.matmul rounds its output to bf16, and on
// CUDA set_float32_matmul_precision("high") means TF32.
//
// Arithmetic. Each float32 operand x is split into hi = bf16(x) and
// lo = bf16(x - hi) (x - hi is exact in float32), and the kernel computes
// hi*hi + (hi*lo + lo*hi): the hi*hi products in one float32 accumulator,
// the two cross terms in a second one, added at the end. The lo*lo term is
// dropped, as on the TPU, so a product errs by about 2^-16 of |a||b| per
// term against the exact float32 dot. Every bf16 x bf16 product is exact in
// float32, so the result differs from bf16x3_mm_plain (three float32
// matmuls of the bf16-exact parts, in PyTorch) only in the order of
// summation. NaN in gives NaN out: a NaN operand splits into NaN halves.
//
// Bound on Hopper: max(bytes / 3.35 TB/s, 3 * 2 * G*M*N*K / 989 TFLOP/s),
// the bytes being A, B and C in float32 read or written once. At the path's
// bulk shapes, (2, n, n) x (2, n, B) with n <= 250 and B up to 16,384, the
// bytes bound: K = n is short (at most 250 values a dot), so each C tile
// costs one pass over a 64-row slab of A and a 64-column slab of B.
//
// Design (simple and right first; wgmma, TMA and a ring of stages are for a
// later PR). A CTA of four warps takes a 64 x 64 tile of C, each warp a
// 32 x 32 quarter: two 16-row by four 8-column mma.sync tiles. It walks k in
// chunks of 32: every thread loads 16 floats of A's chunk and 16 of B's,
// coalesced along whichever of the operand's dims has unit stride (so a
// transposed operand, given by its strides, is never copied), zero past the
// ragged edges; splits them in registers and stores the hi and lo bf16
// tiles to shared memory, k fastest, rows padded to 40 values (80 bytes:
// ldmatrix's eight row addresses land on distinct banks). The next chunk's
// loads are issued before the current chunk's products, so they are in
// flight while the tensor cores work. Per 16 values of k a warp loads its
// fragments with ldmatrix.x4 and issues three
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 a tile. blockIdx.z walks the
// batch (with a stride of gridDim.z past 65,535), and the batch may have two
// levels with strides of their own, so a broadcast or a (G, B) batch of
// views needs no copy.
//
// Three shapes a 64 x 64 tile serves badly take other instances (the
// wrapper's plan picks one; each is the same arithmetic in another order):
// - a batch of dots (M = N = 1: out[g] = sum_k A[g,0,k] B[g,k,0], the
//   factored contraction's later factors): one warp a dot, each lane
//   splitting its operands and summing the three products with FMAs in two
//   float32 accumulators, then a butterfly over the warp;
// - a short k with a thin side (K <= 16 and M or N below 16: the outer
//   products of the factored contraction's backward, K = 1, batched over
//   the B rows), one thread an output, the same FMAs;
// - a long k over few tiles (the backward's (n, B)(B, n) products, K = B,
//   2 ceil(n/64)^2 tiles): k split into S ranges of a multiple of 32, each
//   (tile, range) a CTA writing its partial sum to a scratch buffer, then
//   one pass adding the S partials in the order of s. No atomics, so every
//   call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                             // C tile of a CTA: kTile x kTile
constexpr int kChunk = 32;                            // k per staged chunk
constexpr int kRow = 40;                              // bf16 per staged row: 32 + 8 of skew
constexpr int kThreads = 128;                         // four warps
constexpr int kPer = kTile * kChunk / kThreads;       // floats of one operand a thread loads per chunk
constexpr int kMaxZ = 65535;                          // gridDim.z's limit
constexpr int kDotWarps = 8;                          // warps of a dot-kernel CTA

// One operand as a matrix of "rows" (A's m or B's n) by k, with the strides
// of a two-level batch.
struct Operand {
  const float* p;
  long long s1, s2;  // batch strides (outer, inner)
  long long sr, sk;  // row and k strides
};

__device__ __forceinline__ const float* batch_base(const Operand& X, long long g1, long long g2) {
  return X.p + g1 * X.s1 + g2 * X.s2;
}

// The chunk's (row, k) of the i-th float a thread loads: k fastest when k
// has unit stride, else rows fastest. Either way a warp reads 32
// consecutive addresses.
__device__ __forceinline__ void chunk_pos(bool kfast, int t, int i, int& r, int& k) {
  if (kfast) {
    k = t % kChunk;
    r = t / kChunk + (kThreads / kChunk) * i;
  } else {
    r = t % kTile;
    k = t / kTile + (kThreads / kTile) * i;
  }
}

__device__ __forceinline__ void load_chunk(const float* base, const Operand& X, bool kfast, int rows, int kend,
                                           int r0, int k0, float (&v)[kPer]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int r, k;
    chunk_pos(kfast, t, i, r, k);
    const int gr = r0 + r, gk = k0 + k;
    v[i] = (gr < rows && gk < kend) ? __ldg(base + gr * X.sr + gk * X.sk) : 0.0f;
  }
}

__device__ __forceinline__ void split(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, bool kfast, const float (&v)[kPer]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int r, k;
    chunk_pos(kfast, t, i, r, k);
    split(v[i], hi[r * kRow + k], lo[r * kRow + k]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const __nv_bfloat16* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C, or with S > 1 split s's partial sums at part + (s * batch + g) * M * N,
// of the k range [s * ks, min(K, (s + 1) * ks)).
__global__ void __launch_bounds__(kThreads) bf16x3_mm_kernel(Operand A, Operand B, float* __restrict__ C,
                                                            float* __restrict__ part, int G1, int G2, int M, int N,
                                                            int K, int S, int ks) {
  // [operand][hi, lo][row][k]: A's rows are m, B's rows are n.
  __shared__ __align__(16) __nv_bfloat16 tiles[2][2][kTile * kRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const bool a_kfast = A.sk == 1 || A.sr != 1;
  const bool b_kfast = B.sk == 1 || B.sr != 1;
  const long long batch = static_cast<long long>(G1) * G2;

  for (long long w = blockIdx.z; w < batch * S; w += gridDim.z) {
    const long long g = w / S;
    const int s = static_cast<int>(w % S);
    const long long g1 = g / G2, g2 = g % G2;
    const float* a_base = batch_base(A, g1, g2);
    const float* b_base = batch_base(B, g1, g2);
    const int kbeg = s * ks, kend = min(K, kbeg + ks);
    float hh[2][4][4] = {};  // hi*hi
    float x[2][4][4] = {};   // hi*lo + lo*hi
    float va[kPer], vb[kPer];
    load_chunk(a_base, A, a_kfast, M, kend, m0, kbeg, va);
    load_chunk(b_base, B, b_kfast, N, kend, n0, kbeg, vb);
    for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
      __syncthreads();  // the previous chunk's fragments are read
      store_split(tiles[0][0], tiles[0][1], a_kfast, va);
      store_split(tiles[1][0], tiles[1][1], b_kfast, vb);
      __syncthreads();
      if (k0 + kChunk < kend) {  // the next chunk, in flight during the products
        load_chunk(a_base, A, a_kfast, M, kend, m0, k0 + kChunk, va);
        load_chunk(b_base, B, b_kfast, N, kend, n0, k0 + kChunk, vb);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int off = (wm + mi * 16 + lane % 16) * kRow + kk + (lane / 16) * 8;
          ldsm_x4(ah[mi], tiles[0][0] + off);
          ldsm_x4(al[mi], tiles[0][1] + off);
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int off = (wn + nj * 16 + lane % 8 + (lane / 16) * 8) * kRow + kk + ((lane / 8) % 2) * 8;
          uint32_t r[4];
          ldsm_x4(r, tiles[1][0] + off);
          bh[2 * nj][0] = r[0], bh[2 * nj][1] = r[1], bh[2 * nj + 1][0] = r[2], bh[2 * nj + 1][1] = r[3];
          ldsm_x4(r, tiles[1][1] + off);
          bl[2 * nj][0] = r[0], bl[2 * nj][1] = r[1], bl[2 * nj + 1][0] = r[2], bl[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma(hh[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
            mma(x[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
            mma(x[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
          }
        }
      }
    }
    float* c = S == 1 ? C + g * M * N : part + (s * batch + g) * M * N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm + mi * 16 + lane / 4 + (e / 2) * 8;
          const int col = n0 + wn + ni * 8 + (lane % 4) * 2 + e % 2;
          if (row < M && col < N) c[static_cast<long long>(row) * N + col] = hh[mi][ni][e] + x[mi][ni][e];
        }
      }
    }
  }
}

// out[g] = sum_k A[g, 0, k] B[g, k, 0]: one warp a dot.
__global__ void __launch_bounds__(kDotWarps * 32) bf16x3_dot_kernel(Operand A, Operand B, float* __restrict__ C,
                                                                   int G1, int G2, int K) {
  const int lane = threadIdx.x % 32;
  const long long batch = static_cast<long long>(G1) * G2;
  const long long g = static_cast<long long>(blockIdx.x) * kDotWarps + threadIdx.x / 32;
  if (g >= batch) return;
  const float* a = batch_base(A, g / G2, g % G2);
  const float* b = batch_base(B, g / G2, g % G2);
  float hh = 0.0f, x = 0.0f;
  for (int k = lane; k < K; k += 32) {
    __nv_bfloat16 ah, al, bh, bl;
    split(__ldg(a + k * A.sk), ah, al);
    split(__ldg(b + k * B.sk), bh, bl);
    const float ahf = __bfloat162float(ah), alf = __bfloat162float(al);
    const float bhf = __bfloat162float(bh), blf = __bfloat162float(bl);
    hh = fmaf(ahf, bhf, hh);
    x = fmaf(ahf, blf, x);
    x = fmaf(alf, bhf, x);
  }
#pragma unroll
  for (int s = 16; s > 0; s /= 2) {
    hh += __shfl_xor_sync(0xffffffffu, hh, s);
    x += __shfl_xor_sync(0xffffffffu, x, s);
  }
  if (lane == 0) C[g] = hh + x;
}

// C[i] = the S partials of element i added in the order of s.
__global__ void bf16x3_reduce_kernel(const float* __restrict__ part, float* __restrict__ C, long long total, int S) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < S; ++s) acc += part[s * total + i];
    C[i] = acc;
  }
}

// One thread an output: a short k (the outer products of the backward).
__global__ void bf16x3_short_k_kernel(Operand A, Operand B, float* __restrict__ C, int G1, int G2, int M, int N,
                                      int K) {
  const long long mn = static_cast<long long>(M) * N;
  const long long total = static_cast<long long>(G1) * G2 * mn;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long g = i / mn;
    const int m = static_cast<int>((i % mn) / N), n = static_cast<int>(i % N);
    const float* a = batch_base(A, g / G2, g % G2) + m * A.sr;
    const float* b = batch_base(B, g / G2, g % G2) + n * B.sr;
    float hh = 0.0f, x = 0.0f;
    for (int k = 0; k < K; ++k) {
      __nv_bfloat16 ah, al, bh, bl;
      split(__ldg(a + k * A.sk), ah, al);
      split(__ldg(b + k * B.sk), bh, bl);
      const float ahf = __bfloat162float(ah), alf = __bfloat162float(al);
      const float bhf = __bfloat162float(bh), blf = __bfloat162float(bl);
      hh = fmaf(ahf, bhf, hh);
      x = fmaf(ahf, blf, x);
      x = fmaf(alf, bhf, x);
    }
    C[i] = hh + x;
  }
}

}  // namespace

// C (G1 * G2, M, N), contiguous, = op(A) op(B) with A's element (g1, g2, m,
// k) at A + g1 sA1 + g2 sA2 + m sAm + k sAk and B's (g1, g2, k, n) at
// B + g1 sB1 + g2 sB2 + k sBk + n sBn (strides in elements; a batch stride
// may be 0), by `instance` (0: 64 x 64 tiles, k in S ranges of ks with
// S > 1 writing partials to `scratch`, S * G1 * G2 * M * N floats; 1: a warp
// a dot, M = N = 1; 2: a thread an output). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success). The
// caller has made the tensors' device current.
extern "C" int zigp_bf16x3_mm_f32(const void* A, const void* B, void* C, void* scratch, int G1, int G2, int M,
                                  int N, int K, long long sA1, long long sA2, long long sAm, long long sAk,
                                  long long sB1, long long sB2, long long sBk, long long sBn, int instance, int S,
                                  int ks, void* stream) {
  if (G1 < 0 || G2 < 1 || M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long batch = static_cast<long long>(G1) * G2;
  if (batch == 0 || M == 0 || N == 0) return 0;
  const Operand a{static_cast<const float*>(A), sA1, sA2, sAm, sAk};
  const Operand b{static_cast<const float*>(B), sB1, sB2, sBn, sBk};
  auto* c = static_cast<float*>(C);
  auto s = static_cast<cudaStream_t>(stream);
  const long long total = batch * M * N;
  const auto blocks_of = [](long long n, int threads) {
    const long long b = (n + threads - 1) / threads;
    return static_cast<unsigned>(b < 132LL * 32 ? b : 132LL * 32);  // grid-stride past 32 blocks an SM
  };
  if (instance == 1) {
    if (M != 1 || N != 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (batch + kDotWarps - 1) / kDotWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    bf16x3_dot_kernel<<<static_cast<unsigned>(blocks), kDotWarps * 32, 0, s>>>(a, b, c, G1, G2, K);
  } else if (instance == 2) {
    bf16x3_short_k_kernel<<<blocks_of(total, 256), 256, 0, s>>>(a, b, c, G1, G2, M, N, K);
  } else if (instance == 0) {
    if (S < 1 || ks < kChunk || ks % kChunk != 0 || static_cast<long long>(S) * ks < K ||
        (S > 1 && (scratch == nullptr || static_cast<long long>(S - 1) * ks >= K)))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long work = batch * S;
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile,
                    static_cast<unsigned>(work < kMaxZ ? work : kMaxZ));
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto* part = static_cast<float*>(scratch);
    bf16x3_mm_kernel<<<grid, kThreads, 0, s>>>(a, b, c, part, G1, G2, M, N, K, S, ks);
    if (S > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      bf16x3_reduce_kernel<<<blocks_of(total, 256), 256, 0, s>>>(part, c, total, S);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
