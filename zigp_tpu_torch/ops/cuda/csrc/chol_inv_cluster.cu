// (L, L^-1) of a batch of SPD float32 matrices too large for one SM's shared
// memory (238 < n <= 512 on an H100), one thread-block cluster per matrix.
//
// Replaces the TPU kernel routine chol_inv_blocked of zigp_tpu's
// ops/pallas/chol_inv.py (file and line in PERF.md's kernel table), which
// factors ragged diagonal blocks with the Pallas kernel and does the panels,
// the Schur updates and the block forward substitution of L^-1 as matmuls.
// Here the whole factorization is one launch: the right-looking Cholesky
// with the forward substitution on I carried along, NB = 8 columns a step,
// the operations of chol_inv_plain(K, nb=8) (ops/cuda/chol_inv.py) in its
// order, with a multiply by the IEEE reciprocal of each pivot where the plain
// version divides -- the arithmetic of chol_inv.cu, on the same pieces of
// chol_tile.cuh (factor_diag, panel_row, inv_block_col, tile_update).
//
// Why a cluster. A and L^-1 as padded triangles take about 256 KB at
// n = 250, more than the 227 KB of one SM. A cluster of CTAs on neighbouring
// SMs has that many times the memory, and each CTA can write its peers'
// shared memory (distributed shared memory). Two instances, chosen by
// chol_inv.py's blocked_route:
//   - the pair (at the end of this file), to n = 320: rank 0 factors A as
//     chol.cu does and pushes each step's columns of L to rank 1, which holds
//     L^-1 and computes it a step behind;
//   - the row instance (below), above 320: block rows dealt over C CTAs, C =
//     8 in chol_inv.py's plan (2, 4 and 8 are built; 8 ran fastest), each
//     step's panel copied into every CTA.
// The row instance was the first design; at n = 250 the pair takes about
// chol.cu's time and the row instance much longer (PERF.md §6).
//
// Ownership (row instance). Block row b (rows 8b .. 8b + 7) belongs to rank
// b mod C, which keeps A's and L^-1's rows of it in its shared memory as
// row-padded rows
// (chol_tile.cuh's padded_row offsets, the block rows of a rank packed one
// after another; base[b] maps a row to its place). Dealing the block rows
// cyclically balances the shrinking trailing triangle. Every CTA also keeps
// two staging areas, used by even and odd steps: the step's panel (the rows
// below the step, 8 columns), block row j of L^-1 (8 rows, the columns left
// of the step, stored column by column), and L_jj with its pivots'
// reciprocals. Staged rows and columns carry a float4 of skew per 4, so a
// warp reading the rows of consecutive tiles meets no bank conflict.
//
// Signals. Every value a CTA needs from a peer is pushed by the producer
// with st.async into the consumer's staging area, each store counting its
// bytes on an mbarrier there (complete_tx); the consumer knows how many
// bytes a step brings and waits on that barrier only. Nothing is read
// remotely, and no cluster-wide barrier sits on the chain.
//
// One step j over the columns [j0, j1), in each CTA of the row instance:
//   1. Wait for L_jj (its owner's push, 288 bytes).
//   P. Forward-substitute this CTA's panel rows against L_jj and push each
//      finished row to every CTA; the owner of block j does the same for the
//      columns of block row j of L^-1. These values are final.
//   D. The owner of block j + 1 runs the chain on warp 0 at once: its lanes
//      0-7 took that block's own panel rows, so it updates the block's
//      three diagonal tiles from its own rows, factors the block and pushes
//      L_{j+1} -- before the rest of the step's panel has arrived anywhere.
//   2. Wait for the step's panel and block row of L^-1 (32 n bytes).
//   U. Update this CTA's rows of the trailing A and of L^-1 left of the step
//      in 4 x 4 register tiles from the local staging, one warp a run of 32
//      tiles of one row tile; a __syncthreads() ends the step.
// A producer of step j's data has seen every CTA's step j - 1 panel, which
// each CTA pushes only after its step j - 2 update: so two staging areas
// suffice. The chain from one L_jj to the next is a wait, eight panel rows,
// three tiles, one 8-column factor and a push; the rest of the step runs
// beside it on the other warps and CTAs.
//
// Bound on Hopper: latency. One matrix costs about 2n^3/3 flops and moves
// 3n^2 * 4 bytes, microseconds of work for the card; the time is the chain
// of ceil(n / 8) steps. G = 2 (the f/g pair) fills 2C of 132 SMs.
//
// Numerics: plain f32 FMA arithmetic, IEEE sqrtf and reciprocal (no
// --use_fast_math), no pivot clamp: a non-PSD input gives NaN from the
// failing pivot on, the rows before it as they were. The result is the same,
// bit for bit, for every C, and the same as chol_inv.cu's where both run:
// each entry takes the same operations in the same order whichever CTA
// computes it.

#include <cooperative_groups.h>

#include "chol_tile.cuh"

namespace cg = cooperative_groups;

namespace zigp_cluster {

constexpr int kNB = 8;              // columns a step: chol_inv.cu's width
constexpr int kDiagFloats = 72;     // L_jj as a dense 8 x 8 block, then its 8 reciprocals
constexpr int kDiagBytes = 288;     // what the push of L_jj brings
constexpr int kBarriers = 4;        // L_jj ready (even, odd step), panel staged (even, odd step)

__host__ __device__ inline int ceil4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int num_blocks(int n) { return (n + kNB - 1) / kNB; }

// Offset of staged row (or column) r: 8 floats each, a float4 of skew per 4.
__host__ __device__ __forceinline__ int staged(int r) { return kNB * r + 4 * (r >> 2); }

// Floats of block row b's padded rows (the last block row may be ragged).
__host__ __device__ inline int block_floats(int b, int n) {
  const int end = (b + 1) * kNB < n ? (b + 1) * kNB : n;
  return zigp::padded_row(end) - zigp::padded_row(b * kNB);
}

// Floats of the block rows of rank r.
__host__ __device__ inline int rank_floats(int n, int C, int r) {
  int s = 0;
  for (int b = r; b < num_blocks(n); b += C) s += block_floats(b, n);
  return s;
}

// One CTA's shared memory, in floats from its start; the same in every CTA
// of the cluster, so a peer's staging area is at the same offsets.
struct Layout {
  int region;  // A's rows, then B = L^-1's at the same offsets: the largest rank's
  int ps;      // two staged panels, rows j1 .. n - 1
  int bs;      // two staged block rows of B, columns 0 .. j1 - 1
  int dg;      // two staged L_jj with their reciprocals
  int rown;    // the reciprocals as this CTA's lookahead computes them
  int bars;    // kBarriers mbarriers (8 bytes each)
  int base;    // ints: base[b] = offset of block row b - padded_row(8b), own rows only
  int ps_size, bs_size;
  int floats;
};

__host__ __device__ inline Layout layout(int n, int C) {
  Layout l{};
  int region = 0;
  for (int r = 0; r < C; ++r) {
    const int f = rank_floats(n, C, r);
    region = f > region ? f : region;
  }
  l.region = region;
  l.ps_size = ceil4(staged(n));
  l.bs_size = ceil4(staged(ceil4(n)));
  l.ps = 2 * region;
  l.bs = l.ps + 2 * l.ps_size;
  l.dg = l.bs + 2 * l.bs_size;
  l.rown = l.dg + 2 * kDiagFloats;
  l.bars = l.rown + zigp::kMaxNB;
  l.base = l.bars + 2 * kBarriers;
  l.floats = l.base + ceil4(num_blocks(n));
  return l;
}

__host__ __device__ inline size_t shared_bytes(int n, int C) { return static_cast<size_t>(layout(n, C).floats) * 4; }

// This CTA's rows of A or B: row i of block row b = i / 8 at
// p[base[b] + padded_row(i)].
struct Rows {
  float* p;
  const int* base;
  __device__ __forceinline__ int off(int i) const { return base[i / kNB] + zigp::padded_row(i); }
  __device__ __forceinline__ float& operator()(int i, int k) const { return p[off(i) + k]; }
  __device__ __forceinline__ float4 load4(int i, int k) const {
    return *reinterpret_cast<const float4*>(p + off(i) + k);
  }
  __device__ __forceinline__ void store4(int i, int k, float4 v) const {
    *reinterpret_cast<float4*>(p + off(i) + k) = v;
  }
};

// The staged panel: row i >= j1, columns j0 .. j0 + 7.
struct Staged {
  const float* p;
  int j0, j1;
  __device__ __forceinline__ float4 load4(int i, int k) const {
    return *reinterpret_cast<const float4*>(p + staged(i - j1) + (k - j0));
  }
};

// L_jj as staged: row i at p[8 i].
struct Dense8 {
  const float* p;
  __device__ __forceinline__ float4 load4(int i, int k) const {
    return *reinterpret_cast<const float4*>(p + kNB * i + k);
  }
};

struct NoMarks {
  __device__ __forceinline__ void operator()(int) const {}
};

// --- PTX: the cluster barrier, mbarriers and st.async ------------------------

__device__ __forceinline__ void cluster_sync_all() {
  __syncwarp();  // the .aligned barrier wants the whole warp converged
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of this CTA's shared address a in rank q.
__device__ __forceinline__ unsigned peer_addr(unsigned a, int q) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(q));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This CTA's one arrival of a phase, announcing the bytes the phase brings.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 16 bytes into a peer's shared memory, counted on the peer's mbarrier.
__device__ __forceinline__ void push4(unsigned dst, float4 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

// One arrival on a peer's mbarrier (shared::cluster address), releasing this
// thread's earlier accesses.
__device__ __forceinline__ void bar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// --- end of PTX ----------------------------------------------------------------

// v into this CTA's shared address a in every CTA of the cluster, counted on
// each one's barrier bar.
__device__ __forceinline__ void push_all(int C, unsigned a, float4 v, unsigned bar) {
  for (int q = 0; q < C; ++q) push4(peer_addr(a, q), v, peer_addr(bar, q));
}

// Warp 0 of the owner, after factor_diag on A's rows j0 .. j0 + r - 1: lanes
// 0-15 push L_jj's rows as float4s (zeros where nothing is read), lanes 16-17
// its reciprocals, into every CTA's staged L_jj dg, counted on bar.
__device__ __forceinline__ void push_diag(int C, Rows A, int j0, int r, const float* rown, float* dg, unsigned bar) {
  const int lane = threadIdx.x & 31;
  if (lane >= 18) return;
  float4 v = zigp::zero4();
  int at;
  if (lane < 16) {
    const int i = lane >> 1, k4 = 4 * (lane & 1);
    if (i < r && k4 <= i) v = A.load4(j0 + i, j0 + k4);
    at = kNB * i + k4;
  } else {
    v = *reinterpret_cast<const float4*>(rown + 4 * (lane - 16));
    at = kNB * kNB + 4 * (lane - 16);
  }
  push_all(C, smem_addr(dg + at), v, bar);
}

// One 4 x 4 tile of this CTA's rows at (i0, c0) by the step's 8 columns,
// the panel read through P (the staging, or this CTA's own rows) and block
// row j of B from bs: A's trailing triangle for c0 >= j1, B's rows left of
// the step otherwise.
template <class Panel>
__device__ __forceinline__ void update_tile(Rows A, Rows B, Panel P, const float* bs, int n, int j0, int j1, int i0,
                                            int c0) {
  float acc[zigp::kMT][zigp::kMT];
  if (c0 >= j1) {
    zigp::load_tile(acc, A, i0, c0, n);
    zigp::tile_update<kNB, true>(acc, P, i0, n, j0, [&](int k4, float4(&q)[zigp::kMT]) {  // panel rows c0..c0+3
#pragma unroll
      for (int b = 0; b < zigp::kMT; ++b) q[b] = c0 + b < n ? P.load4(c0 + b, j0 + k4) : zigp::zero4();
    });
    zigp::store_tile(acc, A, i0, c0, n);
  } else {
    zigp::load_tile(acc, B, i0, c0, n);
    zigp::tile_update<kNB, true>(acc, P, i0, n, j0, [&](int k4, float4(&q)[zigp::kMT]) {  // B[j0 + k4 ..][c0 + b]
#pragma unroll
      for (int b = 0; b < zigp::kMT; ++b) q[b] = *reinterpret_cast<const float4*>(bs + staged(c0 + b) + k4);
    });
    zigp::store_tile(acc, B, i0, c0, n);
  }
}

// G clusters of C CTAs along grid x, 512 threads each; cluster g factors
// matrix g. mark(k) is called by every thread after each phase of a step
// (experiments/chol_phases.cu reads clocks there; nothing in the library).
template <class Marks>
__global__ void __launch_bounds__(zigp::kTileThreads, 1)
chol_inv_cluster_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv, int n, bool vec,
                        Marks mark) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t off = static_cast<size_t>(blockIdx.x / C) * n * n;
  const Layout lay = layout(n, C);
  const int nblk = num_blocks(n);
  int* base = reinterpret_cast<int*>(smem + lay.base);
  const Rows A{smem, base}, B{smem + lay.region, base};
  const unsigned bars = smem_addr(smem + lay.bars);  // [0, 1] L_jj staged, [2, 3] panel staged; 8 bytes each
  const auto ready_bar = [&](int J) { return bars + 8 * (J & 1); };
  const auto panel_bar = [&](int J) { return bars + 8 * (2 + (J & 1)); };
  const auto has_panel = [&](int J) { return J < nblk - 1; };  // a step with rows below it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int own_blocks = rank < nblk ? (nblk - 1 - rank) / C + 1 : 0;
  const auto row_of = [&](int w) { return (rank + (w / kNB) * C) * kNB + w % kNB; };
  mark(0);

  if (threadIdx.x == 0) {
    int o = 0;
    for (int b = rank; b < nblk; b += C) {
      base[b] = o - zigp::padded_row(b * kNB);
      o += block_floats(b, n);
    }
    for (int k = 0; k < kBarriers; ++k) bar_init(bars + 8 * k, 1);
    bar_init_fence();
    for (int J = 0; J < 2 && J < nblk; ++J) bar_expect(ready_bar(J), kDiagBytes);
    for (int J = 0; J < 2; ++J)
      if (has_panel(J)) bar_expect(panel_bar(J), 32 * n);
  }
  __syncthreads();
  // this CTA's rows of K's lower triangle into A, and B = I; one warp a row
  for (int w = warp; w < own_blocks * kNB; w += warps) {
    const int i = row_of(w);
    if (i >= n) continue;
    const float* row = K + off + static_cast<size_t>(i) * n;
    for (int k = zigp::kMT * lane; k <= i; k += 32 * zigp::kMT) {
      float4 v;
      if (vec) {
        v = *reinterpret_cast<const float4*>(row + k);
      } else {
        v.x = row[k];
        v.y = k + 1 <= i ? row[k + 1] : 0.0f;
        v.z = k + 2 <= i ? row[k + 2] : 0.0f;
        v.w = k + 3 <= i ? row[k + 3] : 0.0f;
      }
      A.store4(i, k, v);
      B.store4(i, k, make_float4(k == i, k + 1 == i, k + 2 == i, k + 3 == i));
    }
  }
  cluster_sync_all();  // every CTA runs, with its rows and barriers, before any push
  if (rank == 0 && warp == 0) {
    zigp::factor_diag<kNB>(A, 0, min(kNB, n), smem + lay.rown);
    __syncwarp();
    push_diag(C, A, 0, min(kNB, n), smem + lay.rown, smem + lay.dg, ready_bar(0));
  }
  mark(6);

  for (int J = 0; J < nblk; ++J) {
    const int j0 = J * kNB, j1 = min(j0 + kNB, n), r = j1 - j0;
    const bool last = j1 == n;
    const bool ahead = !last && (J + 1) % C == rank;  // this CTA owns the next diagonal block
    float* ps = smem + lay.ps + (J & 1) * lay.ps_size;
    float* bs = smem + lay.bs + (J & 1) * lay.bs_size;
    float* dg = smem + lay.dg + (J & 1) * kDiagFloats;

    bar_wait(ready_bar(J), (J >> 1) & 1);  // L_jj is here
    if (threadIdx.x == 0 && J + 2 < nblk) bar_expect(ready_bar(J), kDiagBytes);
    mark(1);

    // P: this CTA's panel rows below the step and, on the owner, block row J
    // of B. The owner of the next block gives that block's 8 rows to lanes
    // 0-7 of warp 0 and the rest to the other warps.
    const int q0 = J >= rank ? (J - rank) / C + 1 : 0;  // this CTA's first block row below the step
    const int rows = (own_blocks - q0) * kNB;
    const int items = rows + (J % C == rank ? j1 : 0);
    const int first = ahead ? (warp == 0 ? 0 : kNB) : 0;
    const int tid = ahead ? (warp == 0 ? lane : threadIdx.x - 32) : threadIdx.x;
    const int end = ahead && warp == 0 ? kNB : items;
    const int stride = ahead ? (warp == 0 ? kNB : blockDim.x - 32) : blockDim.x;
    if (first + tid < end) {
      float l[kNB][kNB], rinv[kNB];
      zigp::load_diag<kNB>(Dense8{dg}, 0, r, dg + kNB * kNB, l, rinv);
      for (int t = first + tid; t < end; t += stride) {
        if (t < rows) {  // a panel row (rows exist only below a full block)
          const int i = row_of(q0 * kNB + t);
          if (i >= n) continue;
          zigp::panel_row<kNB>(A, i, j0, l, rinv);
          const unsigned a = smem_addr(ps + staged(i - j1));
          push_all(C, a, A.load4(i, j0), panel_bar(J));
          push_all(C, a + 16, A.load4(i, j0 + 4), panel_bar(J));
        } else {  // column col of block row J of B, on its owner
          const int col = t - rows;
          zigp::inv_block_col<kNB>(B, col, j0, r, l, rinv);
          if (!last) {
            float b[kNB];
#pragma unroll
            for (int c = 0; c < kNB; ++c) b[c] = col <= j0 + c ? B(j0 + c, col) : 0.0f;
            const unsigned a = smem_addr(bs + staged(col));
            push_all(C, a, make_float4(b[0], b[1], b[2], b[3]), panel_bar(J));
            push_all(C, a + 16, make_float4(b[4], b[5], b[6], b[7]), panel_bar(J));
          }
        }
      }
    }
    mark(2);
    if (ahead && warp == 0) {
      // D: the chain. The next block's three diagonal tiles by this step's
      // columns, from this CTA's own panel rows (lanes 0-7 just wrote them),
      // then its factor and the push of L_{j+1} to every CTA.
      __syncwarp();
      if (lane < 3) update_tile(A, B, A, nullptr, n, j0, j1, j1 + (lane > 0 ? 4 : 0), j1 + (lane == 2 ? 4 : 0));
      __syncwarp();
      const int r1 = min(j1 + kNB, n) - j1;
      zigp::factor_diag<kNB>(A, j1, r1, smem + lay.rown);
      __syncwarp();
      push_diag(C, A, j1, r1, smem + lay.rown, smem + lay.dg + ((J + 1) & 1) * kDiagFloats, ready_bar(J + 1));
      mark(5);
    }
    if (last) {  // no panel, no update: the factorization is complete once the block row of B is
      __syncthreads();
      break;
    }

    bar_wait(panel_bar(J), (J >> 1) & 1);  // the step's panel and block row of B are staged here
    if (threadIdx.x == 0 && has_panel(J + 2)) bar_expect(panel_bar(J), 32 * n);
    mark(3);

    // U: row tile i0 = 8b + 4h of an own block row b > J takes columns
    // c0 = 0, 4, .., i0 (B left of j1, A from j1), in runs of 32 tiles, one
    // run a warp in turn; the owner of the next block leaves its warp 0 out
    // and the chain's three tiles alone.
    const Staged P{ps, j0, j1};
    const int w0 = ahead ? 1 : 0;
    if (warp >= w0) {
      int g = 0;
      for (int q = q0; q < own_blocks; ++q) {
        const int b = rank + q * C;
        for (int h = 0; h < 2; ++h) {
          const int i0 = b * kNB + 4 * h;
          if (i0 >= n) break;
          const int ntiles = i0 / 4 + 1;
          for (int k = 0; 32 * k < ntiles; ++k, ++g) {
            const int t = 32 * k + lane, c0 = 4 * t;
            if (g % (warps - w0) != warp - w0 || t >= ntiles || (ahead && b == J + 1 && c0 >= j1)) continue;
            update_tile(A, B, P, bs, n, j0, j1, i0, c0);
          }
        }
      }
    }
    __syncthreads();
    mark(4);
  }

  // this CTA's rows of L and L^-1 out, zeros above the diagonal; one warp a row
  for (int w = warp; w < own_blocks * kNB; w += warps) {
    const int i = row_of(w);
    if (i >= n) continue;
    float* lrow = L + off + static_cast<size_t>(i) * n;
    float* brow = Linv + off + static_cast<size_t>(i) * n;
    for (int k = zigp::kMT * lane; k < n; k += 32 * zigp::kMT) {
      float4 v[2] = {k <= i ? A.load4(i, k) : zigp::zero4(), k <= i ? B.load4(i, k) : zigp::zero4()};
      float* dst[2] = {lrow, brow};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (k + 1 > i) v[m].y = 0.0f;
        if (k + 2 > i) v[m].z = 0.0f;
        if (k + 3 > i) v[m].w = 0.0f;
        if (vec) {
          *reinterpret_cast<float4*>(dst[m] + k) = v[m];
        } else {
          dst[m][k] = v[m].x;
          if (k + 1 < n) dst[m][k + 1] = v[m].y;
          if (k + 2 < n) dst[m][k + 2] = v[m].z;
          if (k + 3 < n) dst[m][k + 3] = v[m].w;
        }
      }
    }
  }
  mark(7);
  cluster_sync_all();  // no CTA leaves while a push of a peer may be on its way
}

// One launch: G clusters of C CTAs (C in 2, 4, 8). Returns the launch's
// cudaError_t; cudaErrorInvalidValue if C is not one of those or the
// layout exceeds the device's opt-in shared memory.
template <class Marks>
cudaError_t launch_cluster(const float* K, float* L, float* Linv, int n, int G, int C, cudaStream_t stream,
                           Marks mark) {
  if (n < 1 || G < 1 || !(C == 2 || C == 4 || C == 8) || G > (1 << 27)) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(n, C);
  if (smem > static_cast<size_t>(zigp::optin_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chol_inv_cluster_kernel<Marks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && zigp::aligned16(K) && zigp::aligned16(L) && zigp::aligned16(Linv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * C, 1, 1);
  cfg.blockDim = dim3(zigp::kTileThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chol_inv_cluster_kernel<Marks>, K, L, Linv, n, vec, mark);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}


// ---- The pair instance: one CTA factors, its peer inverts ------------------
//
// For the n whose A fits one SM beside a staging area (to n = 320 on an
// H100), a cluster of 2 splits the work by function, not by rows. Rank 0 runs
// chol_tile.cuh's chol_blocked on A alone -- chol.cu's computation, L only,
// the chain and the lookahead unchanged -- and, through its phase hook, right
// after each step's panel, pushes the step's columns of L (rows j0 .. n - 1,
// 8 floats a row, L_jj included) into rank 1's staging with st.async. Rank 1
// holds B = L^-1 and does chol_inv.cu's L^-1 work for that step from the
// staged columns: block row j of B by forward substitution (inv_block_col),
// then B's rows below by the step's columns in 4 x 4 tiles. So the inverse
// runs beside the factorization, a step behind, and the launch takes about
// the factorization's time. Two staging areas, one per step parity: rank 1
// arrives on a barrier of rank 0 when it is done with one, and rank 0 waits
// on it before filling that area again.

struct PairLayout {
  int region;   // A (rank 0) or B (rank 1), a padded triangle
  int ps;       // two staging areas, rows j0 .. n - 1 of the step's 8 columns
  int ps_size;
  int rinv;     // chol_blocked's pivot reciprocals (rank 0)
  int bars;     // [0, 1] staged (rank 1), [2, 3] staging free again (rank 0)
  int floats;
};

__host__ __device__ inline PairLayout pair_layout(int n) {
  PairLayout l{};
  l.region = ceil4(static_cast<int>(zigp::padded_floats(n)));
  l.ps_size = ceil4(staged(n));
  l.ps = l.region;
  l.rinv = l.ps + 2 * l.ps_size;
  l.bars = l.rinv + zigp::kMaxNB;
  l.floats = l.bars + 2 * kBarriers;
  return l;
}

__host__ __device__ inline size_t pair_bytes(int n) { return static_cast<size_t>(pair_layout(n).floats) * 4; }

// Rank 0's phase hook in chol_blocked: after a step's panel (phase 1, every
// thread, after a barrier), its 8 columns of L go to rank 1; phase 2 ends
// the step.
struct PushColumns {
  zigp::Packed A;
  int n;
  unsigned ps, bars;  // this CTA's shared addresses of the staging and barriers (rank 1's are at the same offsets)
  int ps_size;
  int J;
  __device__ __forceinline__ void operator()(int phase) {
    if (phase == 2) ++J;
    if (phase != 1) return;
    const int j0 = J * kNB;
    if (J >= 2) bar_wait(bars + 8 * (2 + (J & 1)), ((J >> 1) - 1) & 1);  // rank 1 is done with this area
    const unsigned bar = peer_addr(bars + 8 * (J & 1), 1);
    const unsigned base = ps + 4u * (J & 1) * ps_size;
    for (int i = j0 + static_cast<int>(threadIdx.x); i < n; i += blockDim.x) {
      const unsigned a = peer_addr(base + 4u * staged(i - j0), 1);
      push4(a, A.load4(i, j0), bar);  // columns past the diagonal of L_jj's rows are ignored
      push4(a + 16, A.load4(i, j0 + 4), bar);
    }
  }
};

// The staged columns of a step: row i >= j0, columns j0 .. j0 + 7.
struct StagedCols {
  const float* p;
  int j0;
  __device__ __forceinline__ float4 load4(int i, int k) const {
    return *reinterpret_cast<const float4*>(p + staged(i - j0) + (k - j0));
  }
};

__global__ void __launch_bounds__(zigp::kTileThreads, 1)
chol_inv_pair_kernel(const float* __restrict__ K, float* __restrict__ L, float* __restrict__ Linv, int n, bool vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t off = static_cast<size_t>(blockIdx.x / 2) * n * n;
  const PairLayout lay = pair_layout(n);
  const int nblk = num_blocks(n);
  const unsigned bars = smem_addr(smem + lay.bars);
  const zigp::Packed M{smem};  // A on rank 0, B on rank 1
  if (threadIdx.x == 0) {
    for (int k = 0; k < kBarriers; ++k) bar_init(bars + 8 * k, 1);
    bar_init_fence();
    if (rank == 1)
      for (int J = 0; J < 2 && J < nblk; ++J) bar_expect(bars + 8 * J, 32u * (n - J * kNB));
  }
  if (rank == 0)
    zigp::load_lower(K + off, M, n, vec);
  else
    zigp::identity_lower(M, n);
  __syncthreads();
  cluster_sync_all();  // both CTAs run, with their barriers, before any push

  if (rank == 0) {
    zigp::chol_blocked<kNB, false>(M, M, n, smem + lay.rinv,
                                   PushColumns{M, n, smem_addr(smem + lay.ps), bars, lay.ps_size, 0});
    zigp::store_lower(M, L + off, n, vec);
  } else {
    const zigp::Packed B = M;
    for (int J = 0; J < nblk; ++J) {
      const int j0 = J * kNB, j1 = min(j0 + kNB, n), r = j1 - j0;
      bar_wait(bars + 8 * (J & 1), (J >> 1) & 1);  // the step's columns of L are staged
      if (threadIdx.x == 0 && J + 2 < nblk) bar_expect(bars + 8 * (J & 1), 32u * (n - (J + 2) * kNB));
      const StagedCols P{smem + lay.ps + (J & 1) * lay.ps_size, j0};
      // block row J of B: the columns col < j1, against L_jj and the IEEE
      // reciprocals of its pivots (rank 0's factor_diag computes the same)
      if (static_cast<int>(threadIdx.x) < j1) {
        float l[kNB][kNB], rinv[kNB];
        zigp::load_block<kNB>(P, j0, r, l);
#pragma unroll
        for (int c = 0; c < kNB; ++c) rinv[c] = c < r ? 1.0f / l[c][c] : 1.0f;
        for (int col = threadIdx.x; col < j1; col += blockDim.x) zigp::inv_block_col<kNB>(B, col, j0, r, l, rinv);
      }
      __syncthreads();
      // B's rows below the step by its columns, as chol_tile.cuh's update_tiles
      if (j1 < n) {
        const int T = (n - j1 + zigp::kMT - 1) / zigp::kMT, Tc = j1 / zigp::kMT;
        for (int p = threadIdx.x; p < T * Tc; p += blockDim.x) {
          const int ti = p / Tc, i0 = j1 + zigp::kMT * ti, c0 = zigp::kMT * (p - ti * Tc);
          float acc[zigp::kMT][zigp::kMT];
          zigp::load_tile(acc, B, i0, c0, n);
          zigp::tile_update<kNB, false>(acc, P, i0, n, j0, [&](int k4, float4(&q)[zigp::kMT]) {
#pragma unroll
            for (int e = 0; e < zigp::kMT; ++e) q[e] = c0 <= j0 + k4 + e ? B.load4(j0 + k4 + e, c0) : zigp::zero4();
          });
          zigp::store_tile(acc, B, i0, c0, n);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && J + 2 < nblk) bar_arrive_remote(peer_addr(bars + 8 * (2 + (J & 1)), 0));
    }
    zigp::store_lower(B, Linv + off, n, vec);
  }
  cluster_sync_all();  // no CTA leaves while its peer may still signal it
}

cudaError_t launch_pair(const float* K, float* L, float* Linv, int n, int G, cudaStream_t stream) {
  if (n < 1 || G < 1 || G > (1 << 27)) return cudaErrorInvalidValue;
  const size_t smem = pair_bytes(n);
  if (smem > static_cast<size_t>(zigp::optin_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chol_inv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && zigp::aligned16(K) && zigp::aligned16(L) && zigp::aligned16(Linv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * 2, 1, 1);
  cfg.blockDim = dim3(zigp::kTileThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chol_inv_pair_kernel, K, L, Linv, n, vec);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace zigp_cluster

// Bytes of shared memory one CTA takes for n at cluster size C (the same in
// every CTA); ops/cuda/chol_inv.py's plan computes the same number.
extern "C" long long zigp_chol_inv_cluster_smem(int n, int C) {
  return static_cast<long long>(zigp_cluster::shared_bytes(n, C));
}

// (L, L^-1) for G row-major (n, n) float32 matrices, one cluster of C CTAs
// each (C in 2, 4, 8, chosen by the caller's plan). Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on success):
// a refused launch -- a C the device cannot schedule, too much shared memory
// -- never runs, and only this code reports it. The caller has made the
// tensors' device current.
extern "C" int zigp_chol_inv_cluster_f32(const void* K, void* L, void* Linv, int n, int G, int C, void* stream) {
  return static_cast<int>(zigp_cluster::launch_cluster(static_cast<const float*>(K), static_cast<float*>(L),
                                                       static_cast<float*>(Linv), n, G, C,
                                                       static_cast<cudaStream_t>(stream), zigp_cluster::NoMarks{}));
}

// Bytes of shared memory of one CTA of the pair instance for n.
extern "C" long long zigp_chol_inv_pair_smem(int n) { return static_cast<long long>(zigp_cluster::pair_bytes(n)); }

// (L, L^-1) for G row-major (n, n) float32 matrices by the pair instance:
// a cluster of 2 per matrix, rank 0 factoring, rank 1 inverting. Launches on
// `stream` without synchronising and returns the launch's cudaError_t.
extern "C" int zigp_chol_inv_pair_f32(const void* K, void* L, void* Linv, int n, int G, void* stream) {
  return static_cast<int>(zigp_cluster::launch_pair(static_cast<const float*>(K), static_cast<float*>(L),
                                                    static_cast<float*>(Linv), n, G,
                                                    static_cast<cudaStream_t>(stream)));
}
