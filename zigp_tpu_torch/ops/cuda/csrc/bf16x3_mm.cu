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
// summation. NaN in gives NaN out: a NaN operand splits into NaN halves,
// and padding is zero, so a NaN in a row of A reaches that row of C alone.
//
// What bounds it on an H100: max(bytes / 3.35 TB/s, 3 * 2 * G*M*N*K / 989
// TFLOP/s), the bytes being A, B and C in float32 read or written once. At
// the path's bulk shapes, (2, n, n) x (2, n, B) with n <= 250 and B up to
// 16,384, the bytes bound (9.9 us at n = 250, B = 8192), but the three
// passes are not free (6.2 us there). Inside an SM, shared memory is the
// scarce resource: a chunk of k is written by the copy, read and written by
// the split, and read by the tensor cores once per product (168 KB a 32-k
// chunk of a 128 x 128 tile), and the warps that split a chunk are the ones
// that start its products, which hold them while the tensor cores work
// (experiments/bf16x3_phases.py reads the cycles of each phase).
//
// The tile instance: a CTA of two warpgroups takes a 128 x 128 tile of C
// (128 x 64 where k is cut and the tiles are few), each warpgroup 64 rows.
// The five faults of the mma.sync design it replaces, and what this one
// does about each:
// 1. Loads. A ring of kStages = 4 float32 stages of a 32-k chunk of A
//    (128 x 32) and of B (32 x 128), filled asynchronously kStages chunks
//    ahead and tracked by one mbarrier a stage. An operand with unit stride
//    along its contiguous dim and a 16-byte-aligned base, row pitch and
//    batch strides (none of them 0) comes by TMA (cp.async.bulk.tensor, a
//    4-d CUtensorMap encoded on the host at each call and passed as a
//    __grid_constant__ parameter, 128-byte swizzle, zero-filled out of
//    bounds); any other by cp.async, 16, 8 or 4 bytes a copy as the
//    alignment allows, zero-filled past the edges (src-size), each thread's
//    copies arriving on the stage's mbarrier (cp.async.mbarrier.arrive.
//    noinc). Both routes write the stage in the same 128-byte-swizzled
//    layout: rows of 32 floats along the operand's contiguous dim. The
//    wrapper's plan picks the route per operand; a view is read through its
//    strides, never copied.
// 2. The split. Once per staged element, in shared memory: each thread
//    reads 8 floats along the contiguous dim (16-byte loads, conflict-free
//    through the swizzle), splits them and writes 16 bytes of hi and 16 of
//    lo in the layout wgmma's descriptors read, into one of three split
//    buffers. A k-contiguous operand is written K-major (64-byte swizzle),
//    an m- or n-contiguous one MN-major (128-byte swizzle), read with
//    wgmma's transpose flag: no transposing 2-byte stores.
// 3. Products. wgmma.mma_async m64nNk16 bf16 from shared memory (N = 128
//    or 64), per k16 step hi*hi into one accumulator and hi*lo, lo*hi into
//    the other; the products of two chunks in flight (wait_group 1), and a
//    chunk's copies started after its products. A warpgroup whose 64
//    rows are all past M starts none.
// 4. Epilogue. hh + x is staged through shared memory (over the ring) and
//    written by whole rows of the tile: 16-byte stores where N % 4 == 0,
//    coalesced 4-byte ones otherwise.
// 5. Long k. The k of a tile is cut into S ranges by K alone (S <= 8, a
//    multiple of 32 each), one CTA a range, the S CTAs one thread-block
//    cluster; each stages its partial tile, and rank r sums rows
//    [r * ceil(128 / S), ...) of the S partials through distributed shared
//    memory in the order of the ranges and writes them. One launch, no
//    scratch buffer, no atomics: every call gives the same bits, and a
//    batch member's slice does not depend on the batch. Such tiles are 64
//    columns wide where a batch member has at most four of them, so that
//    twice the SMs work and a batch of two still fits one wave of clusters.
//
// Two shapes a 128-row tile serves badly take other instances (the
// wrapper's plan picks one; each is the same arithmetic in another order):
// - a batch of dots (M = N = 1: out[g] = sum_k A[g,0,k] B[g,k,0], the
//   factored contraction's later factors): one warp a dot, each lane
//   splitting its operands and summing the three products with FMAs in two
//   float32 accumulators, then a butterfly over the warp;
// - a short k with a thin side (K <= 16 and T = min(M, N) below 16: the
//   outer products of the factored contraction's backward, K = 1, batched
//   over the B rows; the flagship's factor-10 products, K = 10): each
//   output by the same FMAs in the same order, k ascending, so that it
//   keeps its bits whatever the tiling. Memory bound (a byte read or
//   written for every 3 to 6 operations); the faults of the
//   thread-an-output kernel it replaces, and what this one does:
//   1. Index arithmetic. That kernel took each output's (g, m, n) from a
//      flat 64-bit index and the batch level from g: six 64-bit divisions a
//      4-byte result. Here a CTA takes `members` consecutive batch members
//      by a span of the long side L (whole rows, or spans cut where the
//      batch is too small to fill the SMs); it derives its tile once and
//      each member's (g1, g2) once, in 32-bit arithmetic, and its warps
//      walk the tile with fixed strides.
//   2. The thin operand. Split once per (member, t, k) into shared memory,
//      behind the tile's one barrier, not again for each of the L outputs
//      it multiplies.
//   3. Reads. The long operand is read along its unit stride: lanes along
//      L (16 bytes a lane where its rows are aligned), or, where that
//      stride is along the batch (the factor Ft of the backward, stride B
//      along m), a lane a member (128-byte rows of 32 members), staged in a
//      block of the warp's own, rows padded to 33 floats against bank
//      conflicts, and written by rows of C.
//   4. Stores. Coalesced, by rows of C: 16-byte stores where the rows are
//      aligned (L % 4 == 0), 4-byte ones otherwise. No barrier stands
//      between a warp's reads and its stores, so a wave of CTAs streams
//      (reads and writes overlap) instead of reading all, then writing all
//      (a block barrier there held the first design at 52 % of its bound),
//      and a lane issues every load of a pass before its first product.
//      Splitting the thin values in each warp's registers instead, with no
//      barrier at all, measured slower at the champion's and the
//      flagship's shapes (experiments/bf16x3_short_k.py).
// blockIdx walks the batch (with a stride past the grid's limit), and the
// batch may have two levels with strides of their own, so a broadcast or a
// (G, B) batch of views needs no copy.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Phase marks of the tile loop: experiments/bf16x3_phases.cu includes this source with BF16X3_MARK(k, c) defined
// (clock64() at mark k of chunk c); empty in the library.
#ifndef BF16X3_MARK
#define BF16X3_MARK(k, c)
#endif

namespace {

constexpr int kTile = 128;                              // C tile of a CTA: kTile rows by kTile or kTile / 2 columns
constexpr int kChunk = 32;                              // k per staged chunk
constexpr int kStages = 4;                              // staged chunks in flight
constexpr int kThreads = 256;                           // two warpgroups
constexpr int kMaxCluster = 8;                          // k ranges of a tile at most
constexpr int kOperandStage = kTile * kChunk * 4;       // one operand's float32 chunk: 16 KB
constexpr int kStageBytes = 2 * kOperandStage;          // A's and B's
constexpr int kHalfTile = kTile * kChunk * 2;           // one operand's hi (or lo) chunk in bf16: 8 KB
constexpr int kSplitBytes = 4 * kHalfTile;              // A hi, A lo, B hi, B lo
constexpr int kSplitBufs = 3;                           // split buffers: two chunks' products in flight
constexpr int kCPitch = kTile + 4;                      // floats a row of the staged C tile (at most)
// the ring, the split buffers, an mbarrier a stage, and room to align the swizzles
constexpr int kSmemBytes = kStages * kStageBytes + kSplitBufs * kSplitBytes + kStages * 8 + 1024;
constexpr int kMaxGridY = 65535;
constexpr int kDotWarps = 8;                            // warps of a dot-kernel CTA
constexpr int kSkThreads = 256;                         // threads of a short-k CTA
constexpr int kSkPitch = 33;                            // floats a row of a short-k warp's staged block (odd)
constexpr int kSkMaxK = 16;                             // k of the short-k instance at most
constexpr int kSkMaxThin = 15;                          // its thin side at most
// a short-k CTA's shared memory at most: 32 members' offsets and thin splits (the warps' staged blocks of the
// batch-major mapping, T = 1, take less than the thin splits of T = 15 do)
constexpr int kSkSmemMax = 32 * 8 + 32 * kSkMaxThin * kSkMaxK * 8;
static_assert(32 * 8 + 32 * kSkMaxK * 8 + kSkThreads / 32 * 32 * kSkPitch * 4 <= kSkSmemMax, "the staged blocks");
static_assert(kTile * kCPitch * 4 <= kStages * kStageBytes, "the staged C tile lies over the ring");
static_assert(kSmemBytes <= 232448, "227 KB a CTA");

// One operand as a matrix of "rows" (A's m or B's n) by k, with the strides
// of a two-level batch; `width`: floats a cp.async copy (1, 2 or 4), 0 for TMA.
struct Operand {
  const float* p;
  long long s1, s2;  // batch strides (outer, inner)
  long long sr, sk;  // row and k strides
  int rows;
  int width;
};

__device__ __forceinline__ const float* batch_base(const Operand& X, long long g1, long long g2) {
  return X.p + g1 * X.s1 + g2 * X.s2;
}

__device__ __forceinline__ void split(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// --- PTX: barriers, copies, wgmma, the cluster ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// The stage's mbarrier counts this thread's arrival once its earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` of a W-float copy read from src, the rest of it zero-filled.
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, uint32_t bytes) {
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  } else if constexpr (W == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts64(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `a` in this CTA's shared memory, read from the CTA of cluster rank `rank`.
__device__ __forceinline__ float4 ld_cluster(uint32_t a, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// A shared-memory matrix descriptor: start, leading and stride byte offsets, swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// Keeps the compiler from moving reads or copies of an accumulator register across the wgmma fences and waits.
template <int kLen>
__device__ __forceinline__ void fence_operands(float (&d)[kLen]) {
#pragma unroll
  for (int i = 0; i < kLen; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, the warpgroup's accumulator fragment) += A (64 x 16) B (16 x 128), bf16 from shared memory; TA, TB:
// the operand is MN-major (wgmma's transpose flags).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The same for a 64-column tile: d (64 x 64) += A (64 x 16) B (16 x 64).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB, int kN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128) {
    wgmma_m64n128k16<TA, TB>(d, da, db);
  } else {
    wgmma_m64n64k16<TA, TB>(d, da, db);
  }
}

// --- the tile instance ---

// Byte offset, in a float32 stage, of float `col` (0..31) of staged row `rho` (0..127): rows of 128 bytes, the
// 16-byte chunks of row rho XORed with rho % 8 (TMA's 128-byte swizzle).
__device__ __forceinline__ uint32_t stage_offset(int rho, int col) {
  return rho * 128 + ((((col >> 2) ^ (rho & 7)) << 4) | ((col & 3) << 2));
}

// One operand's chunk of R rows by TMA, into the stage at dst: a k-contiguous operand as one 32 (k) x R (rows) box,
// an MN-contiguous one as R / 32 boxes of 32 (rows) x 32 (k).
template <bool kMn, int R>
__device__ __forceinline__ void tma_operand(const CUtensorMap* map, uint32_t dst, uint32_t bar, int r0, int k0, int g1,
                                            int g2) {
  if (!kMn) {
    tma_load(dst, map, bar, k0, r0, g2, g1);
  } else {
#pragma unroll
    for (int q = 0; q < R / 32; ++q) tma_load(dst + q * 4096, map, bar, r0 + 32 * q, k0, g2, g1);
  }
}

// One operand's chunk by cp.async: this thread's copies of W floats along the contiguous dim, consecutive threads on
// consecutive addresses, zero-filled past the rows or K. The staged row of an element: its row (k-contiguous) or
// 32 * (row / 32) + its k (MN-contiguous). A thread's copies share their position along the contiguous dim and step
// along the other, so their addresses are a base and a stride.
template <bool kMn, int W, int R>
__device__ __forceinline__ void cp_operand_w(const Operand& X, const float* xb, uint32_t dst, int r0, int k0, int K,
                                             int t) {
  constexpr int kPer = (kMn ? R : kChunk) / W;  // copies along the contiguous dim
  constexpr int kStep = kThreads / kPer;       // the other dim's step between a thread's copies
  constexpr int kCopies = R * kChunk / W / kThreads;
  const int c = (t % kPer) * W, o0 = t / kPer;
  if (!kMn) {
    const int gk = k0 + c, left = min(W, K - gk);  // the copy's floats inside K
    const float* src = xb + (r0 + o0) * X.sr + gk * X.sk;
    const uint32_t d0 = dst + stage_offset(o0, c);  // o0 + kStep * i has o0's swizzle
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int valid = (r0 + o0 + kStep * i < X.rows && left > 0) ? left : 0;
      cp_async<W>(d0 + i * kStep * 128, valid ? src + i * kStep * X.sr : X.p, valid * 4);
    }
  } else {
    const int gr = r0 + c, left = min(W, X.rows - gr);  // the copy's floats inside the rows
    const float* src = xb + gr * X.sr + (k0 + o0) * X.sk;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int o = o0 + kStep * i;
      const int valid = (k0 + o < K && left > 0) ? left : 0;
      cp_async<W>(dst + stage_offset((c & ~31) + o, c & 31), valid ? src + i * kStep * X.sk : X.p, valid * 4);
    }
  }
}

template <bool kMn, int R>
__device__ __forceinline__ void cp_operand(const Operand& X, const float* xb, uint32_t dst, int r0, int k0, int K,
                                           int t) {
  if (X.width == 4) {
    cp_operand_w<kMn, 4, R>(X, xb, dst, r0, k0, K, t);
  } else if (X.width == 2) {
    cp_operand_w<kMn, 2, R>(X, xb, dst, r0, k0, K, t);
  } else {
    cp_operand_w<kMn, 1, R>(X, xb, dst, r0, k0, K, t);
  }
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// hi and lo of two floats, packed as two bf16 each (the first in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The split of one operand's staged chunk into its hi and lo bf16 tiles, 8 floats a thread-item (16-byte loads
// along the contiguous dim, 16-byte stores). K-major tile: rows of 32 k (64 bytes), 64-byte swizzle (16-byte chunk
// g of row r at g ^ ((r / 2) % 4)). MN-major tile: two 4 KB atoms of 64 rows, each 32 k-rows of 128 bytes, 128-byte
// swizzle (chunk j of k-row kk at j ^ (kk % 8)).
template <bool kMn, int R>
__device__ __forceinline__ void split_operand(uint32_t stage, uint32_t hi, uint32_t lo, int t) {
#pragma unroll
  for (int it = 0; it < R * 4 / kThreads; ++it) {
    const int i = t + it * kThreads;  // R * 4 items of 8 floats
    const int g = i & 3;
    int rho, dst;
    if (!kMn) {
      rho = i >> 2;
      dst = rho * 64 + ((g ^ ((rho >> 1) & 3)) << 4);
    } else {
      const int kk = (i >> 2) & 31, q = i >> 7;
      rho = q * 32 + kk;
      dst = (q >> 1) * 4096 + kk * 128 + ((((q & 1) * 4 + g) ^ (kk & 7)) << 4);
    }
    const float4 v0 = lds128(stage + stage_offset(rho, 8 * g));
    const float4 v1 = lds128(stage + stage_offset(rho, 8 * g + 4));
    uint4 h, l;
    split2(v0.x, v0.y, h.x, l.x);
    split2(v0.z, v0.w, h.y, l.y);
    split2(v1.x, v1.y, h.z, l.z);
    split2(v1.z, v1.w, h.w, l.w);
    sts128(hi + dst, h);
    sts128(lo + dst, l);
  }
}

// Descriptor of k16 step j of an operand's bf16 tile, for the 64 (A: warpgroup wg's) or 128 (B) rows read.
template <bool kMn>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int rows0, int j) {
  if (!kMn) return gmma_desc(tile + rows0 * 64 + j * 32, 16, 512, 2);
  return gmma_desc(tile + (rows0 / 64) * 4096 + j * 2048, 4096, 1024, 1);
}

// C tiles of 128 x kN (kN = 128, or 64 for the long-k products, whose few tiles would leave SMs idle): blockIdx.y
// walks the tiles (m fastest, then n, then the batch; a stride of gridDim.y past the grid's limit), blockIdx.x (the
// cluster's rank) the S = gridDim.x k ranges of ks each.
template <bool kMnA, bool kMnB, int kN>
__global__ void __launch_bounds__(kThreads, 1)
    bf16x3_tile_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                       Operand A, Operand B, float* __restrict__ C, int G2, int M, int N, int K, int ks, int tiles_m,
                       int tiles_n, long long tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzles repeat every 1024 bytes
  const uint32_t split_base = base + kStages * kStageBytes;
  const uint32_t bars = split_base + kSplitBufs * kSplitBytes;
  const int t = threadIdx.x, wg = t / 128;
  const uint32_t rank = cluster_rank(), S = cluster_size();

  const bool copies = A.width != 0 || B.width != 0;  // an operand comes by cp.async: every thread arrives
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, copies ? kThreads + 1 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kbeg = static_cast<int>(rank) * ks, kend = min(K, kbeg + ks);
  const int nchunks = kend > kbeg ? (kend - kbeg + kChunk - 1) / kChunk : 0;
  const uint32_t tx_bytes = (A.width == 0 ? kOperandStage : 0) + (B.width == 0 ? kN * kChunk * 4 : 0);
  uint32_t used = 0;  // chunks this CTA has consumed: the next is in stage used % kStages, its fill used / kStages

  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int tm = static_cast<int>(tile % tiles_m);
    const long long rest = tile / tiles_m;
    const int tn = static_cast<int>(rest % tiles_n);
    const long long g = rest / tiles_n, g1 = g / G2, g2 = g % G2;
    const int m0 = tm * kTile, n0 = tn * kN;
    const float* a_base = batch_base(A, g1, g2);
    const float* b_base = batch_base(B, g1, g2);
    const CUtensorMap *ma = &map_a, *mb = &map_b;

    // chunk c of this CTA's k range into stage s: TMA by thread 0, cp.async by all, each thread arriving
    const auto fill = [&](int c, uint32_t s) {
      const int k0 = kbeg + c * kChunk;
      const uint32_t st = base + s * kStageBytes, bar = bars + 8 * s;
      if (t == 0) {
        if (tx_bytes) {
          mbar_arrive_expect_tx(bar, tx_bytes);
        } else {
          mbar_arrive(bar);
        }
        if (A.width == 0) tma_operand<kMnA, kTile>(ma, st, bar, m0, k0, static_cast<int>(g1), static_cast<int>(g2));
        if (B.width == 0)
          tma_operand<kMnB, kN>(mb, st + kOperandStage, bar, n0, k0, static_cast<int>(g1), static_cast<int>(g2));
      }
      if (A.width) cp_operand<kMnA, kTile>(A, a_base, st, m0, k0, K, t);
      if (B.width) cp_operand<kMnB, kN>(B, b_base, st + kOperandStage, n0, k0, K, t);
      if (copies) cp_async_arrive(bar);
    };
    for (int c = 0; c < nchunks && c < kStages; ++c) fill(c, (used + c) % kStages);

    float hh[kN / 2], x[kN / 2];  // hi*hi; hi*lo + lo*hi
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) hh[i] = x[i] = 0.0f;
    const bool active = m0 + 64 * wg < M;  // this warpgroup's 64 rows hold some of C
    for (int c = 0; c < nchunks; ++c, ++used) {
      BF16X3_MARK(0, c);
      const uint32_t s = used % kStages;
      mbar_wait(bars + 8 * s, (used / kStages) & 1);
      BF16X3_MARK(1, c);
      const uint32_t st = base + s * kStageBytes, sb = split_base + (c % kSplitBufs) * kSplitBytes;
      split_operand<kMnA, kTile>(st, sb, sb + kHalfTile, t);
      split_operand<kMnB, kN>(st + kOperandStage, sb + 2 * kHalfTile, sb + 3 * kHalfTile, t);
      BF16X3_MARK(2, c);
      wgmma_wait<1>();      // the products of chunk c - 2, the last readers of the buffer split next, are done
      fence_proxy_async();  // the split's stores, before the tensor cores read them
      BF16X3_MARK(3, c);
      __syncthreads();      // stage s split by all; split buffer c % 3 whole
      BF16X3_MARK(4, c);
      if (active) {
        fence_operands(hh);
        fence_operands(x);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint64_t ah = tile_desc<kMnA>(sb, 64 * wg, j), al = tile_desc<kMnA>(sb + kHalfTile, 64 * wg, j);
          const uint64_t bh = tile_desc<kMnB>(sb + 2 * kHalfTile, 0, j);
          const uint64_t bl = tile_desc<kMnB>(sb + 3 * kHalfTile, 0, j);
          wgmma_tile<kMnA, kMnB, kN>(hh, ah, bh);
          wgmma_tile<kMnA, kMnB, kN>(x, ah, bl);
          wgmma_tile<kMnA, kMnB, kN>(x, al, bh);
        }
        wgmma_commit();
        fence_operands(hh);
        fence_operands(x);
      }
      BF16X3_MARK(5, c);
      if (c + kStages < nchunks) fill(c + kStages, s);  // while the tensor cores work
      BF16X3_MARK(6, c);
    }
    wgmma_wait<0>();
    fence_operands(hh);
    fence_operands(x);

    // the partial tile hh + x into shared memory, over the ring (every chunk of this tile has landed and been split)
    {
      const int warp = (t % 128) / 32, lane = t % 32;
      const int r = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
      for (int b = 0; b < kN / 8; ++b) {
        const int col = 8 * b + 2 * (lane % 4);
        sts64(base + (r * kCPitch + col) * 4, hh[4 * b] + x[4 * b], hh[4 * b + 1] + x[4 * b + 1]);
        sts64(base + ((r + 8) * kCPitch + col) * 4, hh[4 * b + 2] + x[4 * b + 2], hh[4 * b + 3] + x[4 * b + 3]);
      }
    }
    fence_proxy_async();  // the next tile's copies overwrite these bytes
    cluster_sync();
    // rank r sums its rows of the S partials in the order of the ranges and writes them
    const int per = (kTile + static_cast<int>(S) - 1) / static_cast<int>(S);
    const int rb = static_cast<int>(rank) * per, re = min(kTile, rb + per);
    for (int i = t; i < (re - rb) * (kN / 4); i += kThreads) {
      const int r = rb + i / (kN / 4), c4 = (i % (kN / 4)) * 4;
      const int m = m0 + r, n = n0 + c4;
      if (m >= M || n >= N) continue;
      const uint32_t off = base + (r * kCPitch + c4) * 4;
      float4 acc = ld_cluster(off, 0);
      for (uint32_t s = 1; s < S; ++s) {
        const float4 v = ld_cluster(off, s);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      float* out = C + (g * M + m) * static_cast<long long>(N) + n;
      if ((N & 3) == 0) {
        *reinterpret_cast<float4*>(out) = acc;
      } else {
        out[0] = acc.x;
        if (n + 1 < N) out[1] = acc.y;
        if (n + 2 < N) out[2] = acc.z;
        if (n + 3 < N) out[3] = acc.w;
      }
    }
    cluster_sync();  // no rank reuses its partial tile while another reads it
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

// --- the short-k instance ---

// The tiling of the (batch x long side) plane, as the wrapper's plan chose it: T the thin side, L the long one;
// a CTA takes `members` members by `span` of L (tiles = ceil(batch / members) * spans, the span fastest).
struct ShortK {
  long long batch, tiles;
  int G2, T, L, K, members, span, spans;
};

__device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// hh += a_hi b_hi; x += a_hi b_lo, then a_lo b_hi, for the long value v and the thin one split (th, tl): the FMAs of
// the other instances. C = A B: with a thin N the long operand is A and the thin one B, else the other way round.
template <bool kThinN>
__device__ __forceinline__ void short_k_fma(float v, float th, float tl, float& hh, float& x) {
  const float vh = bf16_hi(v), vl = bf16_hi(v - vh);
  if (kThinN) {  // a = the long value, b = the thin one
    hh = fmaf(vh, th, hh);
    x = fmaf(vh, tl, x);
    x = fmaf(vl, th, x);
  } else {  // a = the thin value, b = the long one
    hh = fmaf(th, vh, hh);
    x = fmaf(th, vl, x);
    x = fmaf(tl, vh, x);
  }
}

// C (batch, M, N) for K <= 16 with a thin side: kThinN (T = N, the long side L = M) or not (T = M, L = N); kK1:
// K == 1. A CTA splits its members' thin values once into shared memory ([member][t][k], hi then lo, after each
// member's batch offset into the long operand), then its warps stream, with no barrier between their reads and their
// stores; each lane issues all loads of a pass (every k) before its first product (k ascending in every output).
// kMap 0: lanes along L, a warp a (member, t) pair (8 / pairs warps a pair where there are fewer than 8), 8 l's a
// lane a pass (2 where K > 1), each output stored where it is computed; 1: the same, 2 x 4 consecutive l's a lane (4
// where K > 1), 16-byte loads and stores; 2 (T = 1, 32 members, the long operand's unit stride along the batch): a
// warp a chunk of 32 l's of every member, a lane a member (128-byte rows read), staged in the warp's own block (rows
// of kSkPitch floats, odd: no bank conflict) and written by rows of C (16-byte stores where L % 4 == 0).
template <bool kThinN, int kMap, bool kK1>
__global__ void __launch_bounds__(kSkThreads) bf16x3_short_k_kernel(Operand A, Operand B, float* __restrict__ C,
                                                                    ShortK p) {
  extern __shared__ float4 sk_smem[];
  constexpr int kKs = kK1 ? 1 : kSkMaxK;  // k's loaded ahead, each guarded by k < K
  constexpr int kWarps = kSkThreads / 32;
  const int T = p.T, K = kK1 ? 1 : p.K, tk = T * K;
  long long* y_off = reinterpret_cast<long long*>(sk_smem);
  float* x_hi = reinterpret_cast<float*>(y_off + p.members);
  float* x_lo = x_hi + p.members * tk;
  const Operand X = kThinN ? B : A;  // the thin operand: its rows are the thin side
  const Operand Y = kThinN ? A : B;  // the long one
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int group = static_cast<int>(tile / p.spans);
    const int g0 = group * p.members, nm = min(p.members, static_cast<int>(p.batch - g0));
    const int l0 = static_cast<int>(tile - static_cast<long long>(group) * p.spans) * p.span;
    const int l1 = min(p.L, l0 + p.span);
    __syncthreads();  // every warp is done with the previous tile's thin values
    // each member's batch level once (its offset into the long operand); the thin operand split once per
    // (member, t, k)
    const int per = max(tk, 1);  // K = 0: no thin value (every output 0), the offsets all the same
    for (int i = t; i < nm * per; i += kSkThreads) {
      const int gl = i / per, r = i - gl * per, g = g0 + gl, g1 = g / p.G2, g2 = g - g1 * p.G2;
      if (r == 0) y_off[gl] = g1 * Y.s1 + g2 * Y.s2;
      if (tk > 0) {
        const int tt = r / K, k = r - tt * K;
        const float v = __ldg(X.p + g1 * X.s1 + g2 * X.s2 + tt * X.sr + k * X.sk), hi = bf16_hi(v);
        x_hi[i] = hi;
        x_lo[i] = bf16_hi(v - hi);
      }
    }
    __syncthreads();
    if constexpr (kMap < 2) {
      constexpr int kV = kMap == 1 ? 4 : 1;                                  // l's a load
      constexpr int kU = kK1 ? (kMap == 1 ? 2 : 8) : (kMap == 1 ? 1 : 2);  // loads a lane a pass and a k
      const int pairs = nm * T, W = max(1, kWarps / pairs), step = kV * 32 * W;
      for (int q = warp / W; q < pairs; q += kWarps / W) {
        const int gl = q / T, tt = q - gl * T;
        const float* y = Y.p + y_off[gl];
        const float *xh = x_hi + gl * tk + tt * K, *xl = x_lo + gl * tk + tt * K;
        // C's element (g, t, l): ((g T + t) L + l) for a thin M, ((g L + l) T + t) for a thin N
        float* c = C + (kThinN ? static_cast<long long>(g0 + gl) * p.L * T + tt
                               : (static_cast<long long>(g0 + gl) * T + tt) * p.L);
        for (int l = l0 + kV * (lane + 32 * (warp % W)); l < l1; l += kU * step) {
          float v[kKs][kU][kV];  // every load of the pass issued before the first product
#pragma unroll
          for (int k = 0; k < kKs; ++k) {
            if (!kK1 && k >= K) break;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int lu = l + u * step;
              if constexpr (kV == 4) {
                const float4 f = lu < l1 ? __ldg(reinterpret_cast<const float4*>(y + lu + k * Y.sk))
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                v[k][u][0] = f.x, v[k][u][1] = f.y, v[k][u][2] = f.z, v[k][u][3] = f.w;
              } else {
                v[k][u][0] = lu < l1 ? __ldg(y + lu * Y.sr + k * Y.sk) : 0.0f;
              }
            }
          }
          float hh[kU][kV] = {}, x[kU][kV] = {};
#pragma unroll
          for (int k = 0; k < kKs; ++k) {
            if (!kK1 && k >= K) break;
#pragma unroll
            for (int u = 0; u < kU; ++u)
#pragma unroll
              for (int j = 0; j < kV; ++j) short_k_fma<kThinN>(v[k][u][j], xh[k], xl[k], hh[u][j], x[u][j]);
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int lu = l + u * step;
            if (lu >= l1) continue;
            if constexpr (kV == 4) {
              *reinterpret_cast<float4*>(c + lu) = make_float4(hh[u][0] + x[u][0], hh[u][1] + x[u][1],
                                                               hh[u][2] + x[u][2], hh[u][3] + x[u][3]);
            } else {
              c[kThinN ? static_cast<long long>(lu) * T : lu] = hh[u][0] + x[u][0];
            }
          }
        }
      }
    } else {
      float* blk = x_lo + p.members * tk + warp * 32 * kSkPitch;  // this warp's staged block, a row a member
      const bool live = lane < nm;
      const float* y = Y.p + y_off[live ? lane : 0];
      const float *xh = x_hi + (live ? lane : 0) * K, *xl = x_lo + (live ? lane : 0) * K;
      for (int lc = l0 + 32 * warp; lc < l1; lc += 32 * kWarps) {
        const int nlc = min(32, l1 - lc);
        constexpr int kR = kK1 ? 8 : 2;  // l's a group: 8 or 32 floats loaded ahead
#pragma unroll
        for (int rb = 0; rb < 32; rb += kR) {
          float v[kKs][kR];
#pragma unroll
          for (int k = 0; k < kKs; ++k) {
            if (!kK1 && k >= K) break;
#pragma unroll
            for (int u = 0; u < kR; ++u)
              v[k][u] = live && rb + u < nlc ? __ldg(y + (lc + rb + u) * Y.sr + k * Y.sk) : 0.0f;
          }
          float hh[kR] = {}, x[kR] = {};
#pragma unroll
          for (int k = 0; k < kKs; ++k) {
            if (!kK1 && k >= K) break;
#pragma unroll
            for (int u = 0; u < kR; ++u) short_k_fma<kThinN>(v[k][u], xh[k], xl[k], hh[u], x[u]);
          }
#pragma unroll
          for (int u = 0; u < kR; ++u) blk[lane * kSkPitch + rb + u] = hh[u] + x[u];
        }
        __syncwarp();
        float* c = C + static_cast<long long>(g0) * p.L + lc;  // member m's row at c + m L
        if ((p.L & 3) == 0) {  // C's rows start on 16 bytes
          const int j = 4 * (lane % 8);
          for (int m = lane / 8; m < nm; m += 4) {
            const float* b = blk + m * kSkPitch + j;
            if (j < nlc)
              *reinterpret_cast<float4*>(c + static_cast<long long>(m) * p.L + j) = make_float4(b[0], b[1], b[2], b[3]);
          }
        } else {
          for (int m = 0; m < nm; ++m)
            if (lane < nlc) c[static_cast<long long>(m) * p.L + lane] = blk[m * kSkPitch + lane];
        }
        __syncwarp();  // the block is read before the next chunk writes it
      }
    }
  }
}

// --- host side ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-d map of an operand's chunk boxes (contiguous dim, the other, inner batch, outer batch), 128-byte
// swizzled, zero-filled out of bounds. The plan sends an operand here only where TMA takes it: unit stride along
// the contiguous dim, base and every other stride of a dim longer than 1 a nonzero multiple of 16 bytes.
bool encode_operand(CUtensorMap* map, const Operand& X, bool mn, int rows_box, int K, int G1, int G2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(X.p) & 15) != 0 || X.rows < 1 || K < 1) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(mn ? X.rows : K), static_cast<cuuint64_t>(mn ? K : X.rows),
                        static_cast<cuuint64_t>(G2), static_cast<cuuint64_t>(G1)};
  const long long other = mn ? X.sk : X.sr;
  cuuint64_t strides[3];
  strides[0] = static_cast<cuuint64_t>(dims[1] > 1 ? other * 4 : 16);
  strides[1] = G2 > 1 ? static_cast<cuuint64_t>(X.s2 * 4) : strides[0] * dims[1];
  strides[2] = G1 > 1 ? static_cast<cuuint64_t>(X.s1 * 4) : strides[1] * dims[2];
  for (const cuuint64_t s : strides) {
    if (s == 0 || s % 16 != 0 || s >= (1ULL << 40)) return false;
  }
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(mn ? 32 : rows_box), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(X.p), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A copy route the kernel can take: TMA, or cp.async of 2 or 4 floats, only along a unit-stride dim.
bool route_ok(const Operand& X, bool mn) {
  if (X.width == 1) return true;
  return (X.width == 0 || X.width == 2 || X.width == 4) && (mn ? X.sr : X.sk) == 1;
}

template <bool kMnA, bool kMnB, int kN>
cudaError_t launch_tiles(const CUtensorMap& ma, const CUtensorMap& mb, const Operand& a, const Operand& b, float* c,
                         int G2, int M, int N, int K, int S, int ks, long long batch, cudaStream_t stream) {
  static unsigned ready = 0;  // devices whose function attribute is set: once, at the first (eager) call
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto kernel = bf16x3_tile_kernel<kMnA, kMnB, kN>;
  if (dev >= 32 || !(ready & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < 32) ready |= 1u << dev;
  }
  const int tiles_m = (M + kTile - 1) / kTile, tiles_n = (N + kN - 1) / kN;
  const long long tiles = batch * tiles_m * tiles_n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S), static_cast<unsigned>(tiles < kMaxGridY ? tiles : kMaxGridY), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ma, mb, a, b, c, G2, M, N, K, ks, tiles_m, tiles_n, tiles);
}

template <bool kThinN, int kMap, bool kK1>
cudaError_t launch_short_k(const Operand& a, const Operand& b, float* c, const ShortK& p, int smem,
                           cudaStream_t stream) {
  static unsigned ready = 0;  // devices whose function attribute is set: once, at the first (eager) call
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto kernel = bf16x3_short_k_kernel<kThinN, kMap, kK1>;
  if (dev >= 32 || !(ready & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSkSmemMax);
    if (err != cudaSuccess) return err;
    if (dev < 32) ready |= 1u << dev;
  }
  const unsigned grid = static_cast<unsigned>(p.tiles < 0x7fffffffLL ? p.tiles : 0x7fffffffLL);
  kernel<<<grid, kSkThreads, smem, stream>>>(a, b, c, p);
  return cudaSuccess;
}

}  // namespace

// C (G1 * G2, M, N), contiguous, = op(A) op(B) with A's element (g1, g2, m, k) at A + g1 sA1 + g2 sA2 + m sAm +
// k sAk and B's (g1, g2, k, n) at B + g1 sB1 + g2 sB2 + k sBk + n sBn (strides in elements; a batch stride may be
// 0). `params` (host memory, read before the launch): G1, G2, M, N, K, sA1, sA2, sAm, sAk, sB1, sB2, sBk, sBn,
// instance (0: the tiles, 1: a warp a dot, M = N = 1; 2: a short k), S (the tiles' k ranges, a cluster of S CTAs,
// 1..8), ks (k a range, a multiple of 32; S * ks >= K > (S - 1) * ks), A's and B's copy routes (0: TMA, else floats
// a cp.async copy: 1, 2 or 4), the tiles' columns (128 or 64); the short k's thin side (0: M, 1: N; at most 15, K at
// most 16), its mapping (0: lanes along the long side; 1: the same by 16 bytes, where the long operand has unit
// stride along it and every row base of it and of C is 16-byte aligned; 2: lanes along the batch, T = 1, 32
// members), members a CTA (a power of two to 32), the span of the long side a CTA. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue, nothing launched, for
// parameters the kernel cannot take or a tensor map the driver refuses). The caller has made the tensors' device
// current.
extern "C" int zigp_bf16x3_mm_f32(const void* A, const void* B, void* C, const long long* params, void* stream) {
  const int G1 = static_cast<int>(params[0]), G2 = static_cast<int>(params[1]);
  const int M = static_cast<int>(params[2]), N = static_cast<int>(params[3]), K = static_cast<int>(params[4]);
  const int instance = static_cast<int>(params[13]), S = static_cast<int>(params[14]);
  const int ks = static_cast<int>(params[15]), tile_n = static_cast<int>(params[18]);
  if (G1 < 0 || G2 < 1 || M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long batch = static_cast<long long>(G1) * G2;
  if (batch == 0 || M == 0 || N == 0) return 0;
  Operand a{static_cast<const float*>(A), params[5], params[6], params[7], params[8], M,
            static_cast<int>(params[16])};
  Operand b{static_cast<const float*>(B), params[9], params[10], params[12], params[11], N,
            static_cast<int>(params[17])};
  auto* c = static_cast<float*>(C);
  auto s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    if (M != 1 || N != 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (batch + kDotWarps - 1) / kDotWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    bf16x3_dot_kernel<<<static_cast<unsigned>(blocks), kDotWarps * 32, 0, s>>>(a, b, c, G1, G2, K);
  } else if (instance == 2) {
    const int thin_n = static_cast<int>(params[19]), map = static_cast<int>(params[20]);
    const int members = static_cast<int>(params[21]), span = static_cast<int>(params[22]);
    const int T = thin_n ? N : M, L = thin_n ? M : N;
    const Operand& y = thin_n ? a : b;  // the long operand
    // the 16-byte route: 4 consecutive l's on unit stride, every base of the long operand's and of C's rows aligned
    const bool aligned = y.sr == 1 && ((reinterpret_cast<uintptr_t>(y.p) | reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
                         (G1 == 1 || y.s1 % 4 == 0) && (G2 == 1 || y.s2 % 4 == 0) && (K <= 1 || y.sk % 4 == 0) &&
                         L % 4 == 0 && span % 4 == 0 && (!thin_n || T == 1);
    if ((thin_n != 0 && thin_n != 1) || map < 0 || map > 2 || K > kSkMaxK || T > kSkMaxThin ||
        batch > 0x7fffffffLL || members < 1 || members > 32 || (members & (members - 1)) || span < 1 || span > L ||
        (map == 1 && !aligned) || (map == 2 && (T != 1 || members != 32)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int spans = (L + span - 1) / span;
    const ShortK p{batch, (batch + members - 1) / members * spans, G2, T, L, K, members, span, spans};
    const int smem = members * 8 * (1 + T * K) + (map == 2 ? kSkThreads / 32 * 32 * kSkPitch * 4 : 0);
    using Launch = cudaError_t (*)(const Operand&, const Operand&, float*, const ShortK&, int, cudaStream_t);
    static const Launch launches[2][3][2] = {
        {{launch_short_k<false, 0, false>, launch_short_k<false, 0, true>},
         {launch_short_k<false, 1, false>, launch_short_k<false, 1, true>},
         {launch_short_k<false, 2, false>, launch_short_k<false, 2, true>}},
        {{launch_short_k<true, 0, false>, launch_short_k<true, 0, true>},
         {launch_short_k<true, 1, false>, launch_short_k<true, 1, true>},
         {launch_short_k<true, 2, false>, launch_short_k<true, 2, true>}}};
    const cudaError_t err = launches[thin_n][map][K == 1](a, b, c, p, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (instance == 0) {
    if (S < 1 || S > kMaxCluster || ks < kChunk || ks % kChunk != 0 || static_cast<long long>(S) * ks < K ||
        (S > 1 && static_cast<long long>(S - 1) * ks >= K))
      return static_cast<int>(cudaErrorInvalidValue);
    // the contiguous dim of each operand, as the plan read it: k unless the rows have unit stride and k does not
    const bool mn_a = a.sk != 1 && a.sr == 1, mn_b = b.sk != 1 && b.sr == 1;
    if (!route_ok(a, mn_a) || !route_ok(b, mn_b)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ma = {}, mb = {};
    if (tile_n != kTile && tile_n != kTile / 2) return static_cast<int>(cudaErrorInvalidValue);
    if ((a.width == 0 && !encode_operand(&ma, a, mn_a, kTile, K, G1, G2)) ||
        (b.width == 0 && !encode_operand(&mb, b, mn_b, tile_n, K, G1, G2)))
      return static_cast<int>(cudaErrorInvalidValue);
    using Launch = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&, const Operand&, const Operand&, float*, int,
                                   int, int, int, int, int, long long, cudaStream_t);
    static const Launch launches[2][2][2] = {
        {{launch_tiles<false, false, 128>, launch_tiles<false, false, 64>},
         {launch_tiles<false, true, 128>, launch_tiles<false, true, 64>}},
        {{launch_tiles<true, false, 128>, launch_tiles<true, false, 64>},
         {launch_tiles<true, true, 128>, launch_tiles<true, true, 64>}}};
    const Launch launch = launches[mn_a][mn_b][tile_n == kTile ? 0 : 1];
    const cudaError_t err = launch(ma, mb, a, b, c, G2, M, N, K, S, ks, batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
