"""The tile plan of ``csrc/bf16x3_mm.cu``, pinned on the CPU.

The kernel cannot run here, so its plan (``bf16x3.plan`` and ``plan_of``:
the instance, the k ranges of a tile's cluster, the grid, each operand's
copy route, the shared memory) and the CTAs it derives from them
(``bf16x3.ctas``, in the kernel's own order) are what these tests hold:

- at the path's shapes and at ragged ones, the CTAs of the tile instance's
  grid write every (g, m, n) of C exactly once, and a tile's cluster ranks
  cover its k exactly once, in ranges of a multiple of 32 taken in rank
  order, each written row the sum of every rank's partial in that order;
- the k partition of (G, M, N, K) is the one of (1, M, N, K): a batch
  member's result does not depend on the batch (the folded member stack);
- the copy route follows the 16-byte rule: TMA for a contiguous
  (2, 250, 8192) operand and the long-k products' (2, n, B) ones, cp.async
  for a (2, 250, 250) contiguous factor (1000-byte rows), a base one float
  off and a broadcast batch (a batch stride of 0), as wide as the
  alignment allows;
- a CTA's shared memory is within the card's 232,448 bytes, and the
  source's constants are the plan's;
- an emulation that walks the plan CTA by CTA (zero-filled 32-k chunks,
  each range's partial tile, the ranks' partials added in order) agrees
  with ``bf16x3_mm_plain`` within the kernel's gate, 2·K·2⁻²⁴·Σ|a||b|, and
  the CPU route is the plain version, bit for bit, counting no launch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zigp_tpu_torch.ops.cuda import bf16x3 as bx

from .torch_helpers import one_torch_thread_per_module  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread_per_module")

SOURCE = Path(bx.__file__).resolve().parent / "csrc" / "bf16x3_mm.cu"
SHAPES = [(2, 250, 250, 8192), (2, 250, 8192, 250), (2, 105, 105, 8192), (2, 105, 250, 8192), (10, 100, 100, 1000),
          (3, 64, 64, 257), (16384, 1, 250, 1), (2, 200, 4000, 200), (2, 200, 200, 4000), (2, 32, 32, 4000),
          (2, 8192, 250, 105), (1, 129, 130, 33), (2, 20, 30, 0), (2, 10, 10, 0), (70000, 3, 2, 20)]


def _tiles(p, G, M, N, K):
    """{(g, m0, n0): [CTA, ...]} of the plan's grid."""
    out = {}
    for cta in bx.ctas(p, G, M, N, K):
        out.setdefault((cta.g, cta.m.start, cta.n.start), []).append(cta)
    return out


@pytest.mark.parametrize("G,M,N,K", SHAPES)
def test_plan_writes_c_once(G, M, N, K):
    p = bx.plan(G, M, N, K)
    if M == N == 1:
        assert p.instance == "dots"
        return
    if K <= 16 and min(M, N) < 16:
        assert p.instance == "short_k" and p.grid == (1, 1, 1)
        return
    assert p.instance == "tiles" and p.grid[0] == p.splits and 1 <= p.splits <= bx.MAX_CLUSTER
    narrow = p.splits > 1 and -(-M // bx.TILE) * -(-N // (bx.TILE // 2)) <= bx.NARROW_TILES
    assert p.tile_n == (bx.TILE // 2 if narrow else bx.TILE)
    tiles = G * -(-M // bx.TILE) * -(-N // p.tile_n)
    assert p.grid[1] == min(tiles, bx.MAX_GRID_Y) and p.grid[2] == 1
    cover = np.zeros((G, M, N), np.int16)
    for cta in bx.ctas(p, G, M, N, K):
        assert 0 <= cta.g < G and 0 <= cta.rank < p.splits
        assert cta.m.start % bx.TILE == 0 and len(cta.m) <= bx.TILE and cta.n.start % p.tile_n == 0
        assert len(cta.n) <= p.tile_n and cta.m.stop <= M and cta.n.stop <= N
        assert cta.writes.start >= cta.m.start and cta.writes.stop <= cta.m.stop
        cover[cta.g, cta.writes.start:cta.writes.stop, cta.n.start:cta.n.stop] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("G,M,N,K", SHAPES)
def test_k_ranges_cover_k_once_in_order(G, M, N, K):
    p = bx.plan(G, M, N, K)
    if p.instance != "tiles":
        return
    S, ks = p.splits, p.ks
    assert ks % bx.CHUNK == 0 and S * ks >= K and (S == 1 or (S - 1) * ks < K)
    for key, cluster in _tiles(p, G, M, N, K).items():
        assert [c.rank for c in cluster] == list(range(S))  # one CTA a range, the cluster's ranks in order
        assert all(c.sums == tuple(range(S)) for c in cluster)  # every written row adds the ranks in order
        ks_covered = [k for c in cluster for k in c.k]
        assert ks_covered == list(range(K))  # each k once, in order of rank
        assert all(len(c.k) > 0 for c in cluster) or K == 0
        assert all(c.k.start % bx.CHUNK == 0 for c in cluster)  # a range starts on a chunk
        rows = [m for c in cluster for m in c.writes]
        assert rows == list(range(key[1], min(M, key[1] + bx.TILE)))  # the ranks share the tile's rows out


@pytest.mark.parametrize("G,M,N,K", SHAPES)
def test_k_partition_depends_on_k_alone(G, M, N, K):
    p, one = bx.plan(G, M, N, K), bx.plan(1, M, N, K)
    assert (p.instance, p.splits, p.ks, p.tile_n) == (one.instance, one.splits, one.ks, one.tile_n)
    assert (p.splits, p.ks) == (bx.k_ranges(K) if p.instance == "tiles" else (1, bx.CHUNK))


def _f(*shape):
    return torch.zeros(*shape)


ROUTE_CASES = {
    # name: (a, b, A's route, B's route)
    "the grid's bulk product": (_f(2, 250, 250), _f(2, 250, 8192), "cp.async8", "tma"),
    "L⁻ᵀ V": (_f(2, 250, 250).transpose(-1, -2), _f(2, 250, 8192), "cp.async8", "tma"),
    "the long-k product": (_f(2, 250, 8192), _f(2, 250, 8192).transpose(-1, -2), "tma", "tma"),
    "the long-k product, B contiguous": (_f(2, 105, 8192), _f(2, 8192, 105), "tma", "cp.async4"),
    "(105, 105) factor": (_f(2, 105, 105), _f(2, 105, 8192), "cp.async4", "tma"),
    "(200, 200) factor": (_f(2, 200, 200), _f(2, 200, 4000), "tma", "tma"),
    "a base one float off": (_f(2, 100, 101)[..., 1:], _f(2, 100, 1001)[..., 1:], "cp.async4", "cp.async4"),
    "a base one float off, aligned rows": (_f(2, 4100)[:, 1:4097].reshape(2, 64, 64), _f(2, 64, 64), "cp.async4",
                                           "tma"),
    "a broadcast batch (stride 0)": (_f(100, 100).expand(3, 100, 100), _f(3, 100, 1000), "cp.async16", "tma"),
    "a (G, B) batch of views": (_f(4, 32, 32).unsqueeze(1).expand(4, 3, 32, 32), _f(4, 3, 32, 200), "cp.async16",
                                "tma"),
    "neither dim of unit stride": (_f(2, 64, 64, 2)[..., 0], _f(2, 64, 128), "cp.async4", "tma"),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_copy_route_follows_the_16_byte_rule(name):
    a, b, ra, rb = ROUTE_CASES[name]
    p = bx.plan_of(a, b)
    assert p.instance == "tiles" and (p.a_route, p.b_route) == (ra, rb)
    assert p.label == f"tiles A:{ra} B:{rb}"
    assert (p.splits, p.ks) == bx.k_ranges(a.shape[-1])


def test_a_batch_two_strides_cannot_walk_is_planned_as_its_copies():
    a = torch.zeros(2, 3, 5, 8, 8)
    b = torch.zeros(5, 3, 2, 8, 8).permute(2, 1, 0, 3, 4)
    assert bx._batch_levels(a, b) is None
    assert bx.plan_of(a, b) == bx.plan_of(a, b.contiguous())


def test_shared_memory_and_the_source_constants():
    src = SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kTile"], consts["kChunk"], consts["kStages"], consts["kSplitBufs"], consts["kThreads"],
            consts["kMaxCluster"], consts["kMaxGridY"]) == (bx.TILE, bx.CHUNK, bx.STAGES, bx.SPLIT_BUFS, bx.THREADS,
                                                            bx.MAX_CLUSTER, bx.MAX_GRID_Y)
    p = bx.plan(2, 250, 8192, 250)
    assert p.smem == bx.smem_bytes() <= bx.SMEM_LIMIT == 232_448
    tile_kernel = src[src.index("bf16x3_tile_kernel("):src.index("bf16x3_dot_kernel(")]
    assert "wgmma.mma_async" in src and "mbarrier.try_wait" in src and "cp.async.bulk.tensor" in src
    assert "mma.sync.aligned" not in src and "reduce_kernel" not in src  # no mma.sync, no second pass
    assert "__ldg" not in tile_kernel and "atomic" not in tile_kernel and "red." not in tile_kernel


def _tiled(a, b, p):
    """C by the plan's CTAs in float64: each rank's partial over its k range
    in zero-filled chunks of 32 (each chunk's three products of the split
    parts), the ranks' partials added in rank order."""
    G, M, K = a.shape
    N = b.shape[-1]
    (ah, al), (bh, bl) = bx.split_bf16(a), bx.split_bf16(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    out = torch.full((G, M, N), float("nan"), dtype=torch.float64)
    for (g, m0, n0), cluster in _tiles(p, G, M, N, K).items():
        m, n = slice(m0, m0 + bx.TILE), slice(n0, n0 + p.tile_n)
        partials = []
        for cta in cluster:
            acc = torch.zeros(min(M, m0 + bx.TILE) - m0, min(N, n0 + p.tile_n) - n0, dtype=torch.float64)
            for k0 in range(cta.k.start, cta.k.stop, bx.CHUNK):
                k = slice(k0, min(cta.k.stop, k0 + bx.CHUNK))
                acc += ah[g, m, k] @ bh[g, k, n] + (ah[g, m, k] @ bl[g, k, n] + al[g, m, k] @ bh[g, k, n])
            partials.append(acc)
        for cta in cluster:
            rows = slice(cta.writes.start - m0, cta.writes.stop - m0)
            total = partials[cta.sums[0]][rows]
            for r in cta.sums[1:]:
                total = total + partials[r][rows]
            out[g, cta.writes.start:cta.writes.stop, n] = total
    return out


@pytest.mark.parametrize("G,M,N,K", [(2, 250, 300, 1000), (3, 64, 64, 257), (2, 130, 129, 2100), (1, 20, 30, 40),
                                     (2, 20, 30, 0)])
def test_emulation_matches_the_plain_version(G, M, N, K):
    rng = np.random.RandomState(M + N + K)
    a = torch.as_tensor(rng.randn(G, M, K).astype(np.float32))
    b = torch.as_tensor(rng.randn(G, K, N).astype(np.float32))
    p = bx.plan(G, M, N, K)
    got = _tiled(a, b, p)
    plain = bx.bf16x3_mm_plain(a, b).double()
    bound = K * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert torch.isfinite(got).all()  # every element written
    assert torch.all((got - plain).abs() <= 2.0 * bound)


def test_cpu_route_is_the_plain_version():
    a, b = torch.randn(2, 30, 17), torch.randn(2, 17, 40)
    counts = (bx.bf16x3_mm_cuda.launches, dict(bx.bf16x3_mm_cuda.launches_by_instance))
    assert torch.equal(bx.bf16x3_mm_cuda(a, b), bx.bf16x3_mm_plain(a, b))
    assert (bx.bf16x3_mm_cuda.launches, dict(bx.bf16x3_mm_cuda.launches_by_instance)) == counts
