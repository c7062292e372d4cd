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
  the CPU route is the plain version, bit for bit, counting no launch;
- the short-k instance (K ≤ 16 with a thin side): the instance each shape
  takes is the one it took before the short-k tiling; the layout the plan
  reads from the strides (the long operand's unit stride along the long
  side, along the batch, or neither) and its 16-byte stores at the path's
  (G, 1, 1)·(G, 1, n) and (G, n, 1)·(G, 1, 1) products, the flagship's
  factor-10 products and at a two-level batch, a batch stride of 0, K =
  0..16, either thin side, N % 4 ≠ 0 and long sides cut into spans; its
  CTAs (``bf16x3.short_k_ctas``) store every element of C exactly once,
  from a CTA whose members and span hold it, every 16-byte run on 16 bytes;
  and an emulation that walks those CTAs and runs (the kernel's FMAs in
  float32: a product of bf16 values is exact) gives the bits of the
  untiled product and agrees with ``bf16x3_mm_plain`` within
  2·K·2⁻²⁴·Σ|a||b|.
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
        assert p.instance == "short_k" and p.grid[0] == -(-G // p.members) * -(-max(M, N) // p.span)
        cover = np.zeros(G * M * N, np.int16)
        for cta in bx.short_k_ctas(p, G, M, N):
            for run in cta.runs:
                cover[run.c:run.c + run.n * run.step:run.step] += 1
        assert (cover == 1).all()
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


# each shape's instance before the short-k instance was tiled
INSTANCE_OF = {(16384, 1, 250, 1): "short_k", (2, 10, 10, 0): "short_k"}


@pytest.mark.parametrize("G,M,N,K", SHAPES)
def test_instance_choice_is_unchanged(G, M, N, K):
    assert bx.plan(G, M, N, K).instance == INSTANCE_OF.get((G, M, N, K), "tiles")
    for layout in ("n-major", "m-major", "batch-major", "strided"):
        for aligned in (False, True):
            assert bx.plan(G, M, N, K, layout=layout, aligned=aligned).instance == bx.plan(G, M, N, K).instance


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
    assert (consts["kSkThreads"], consts["kSkPitch"], consts["kSkMaxK"], consts["kSkMaxThin"]) == (
        bx.SK_THREADS, bx.SK_PITCH, bx.SK_MAX_K, bx.SK_MAX_THIN)
    assert bx.SK_PITCH % 2 == 1  # a warp's 32 members, a row each, land on 32 banks
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


# --- the short-k instance ---


def _r(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape)))


SK_CASES = {
    # name: (a, b, the plan's label); the path's products first: dF = dC·tᵀ and dt = Fᵀ·dC, F the (2, n, B) factor
    "dF grid": (_f(2, 8192, 1, 1), _f(2, 8192, 250, 1).mT, "short_k n-major st4"),
    "Ft grid": (_f(2, 250, 8192).mT.unsqueeze(-1), _f(2, 8192, 1, 1), "short_k batch-major st4"),
    "dF champion": (_f(2, 4000, 1, 1), _f(2, 4000, 200, 1).mT, "short_k n-major st16"),
    "Ft champion": (_f(2, 200, 4000).mT.unsqueeze(-1), _f(2, 4000, 1, 1), "short_k batch-major st16"),
    "Ft flagship": (_f(2, 100, 1000).mT.unsqueeze(-1), _f(2, 1000, 1, 1), "short_k batch-major st16"),
    "the factor as B, thin M": (_f(2, 8192, 1, 1), _f(2, 105, 8192).mT.unsqueeze(-2), "short_k batch-major st4"),
    "(G, n, 1) contiguous": (_f(2, 1000, 200, 1), _f(2, 1000, 1, 1), "short_k m-major st16"),
    "the flagship's factor-10 product": (_f(2, 10, 10), _f(2, 10, 1000), "short_k n-major st16"),
    "its transpose": (_f(2, 10, 10).mT, _f(2, 10, 4096), "short_k n-major st16"),
    "the long operand one float off": (_f(2, 10, 10), _f(2, 10, 1001)[..., 1:], "short_k n-major st4"),
    "neither unit stride, K = 2": (_f(300, 1, 2), _f(300, 2, 250, 2)[..., 0], "short_k strided st4"),
    "a batch stride of 0": (_f(1, 1, 1).expand(500, 1, 1), _f(500, 1, 252), "short_k n-major st16"),
    "the long operand broadcast, K = 3": (_f(500, 1, 3), _f(1, 3, 250).expand(500, 3, 250), "short_k n-major st4"),
    "a (G, B) batch of views": (_f(4, 1, 1, 1).expand(4, 50, 1, 1), _f(4, 50, 1, 105), "short_k n-major st4"),
    "K = 16, thin M = 15": (_f(40, 15, 16), _f(40, 16, 60), "short_k n-major st16"),
    "thin N = 15 along the batch: strided": (_f(7, 60, 33).permute(2, 1, 0), _f(33, 7, 15), "short_k strided st4"),
    "thin N = 3, m-major, K = 4": (_f(5, 4, 2000).mT, _f(5, 4, 3), "short_k m-major st4"),
    "thin M, N % 4 = 1, past one span": (_f(3, 2, 1), _f(3, 1, 2501), "short_k n-major st4"),
    "batch-major, M % 4 = 2": (_f(1030, 1, 20).permute(2, 0, 1), _f(20, 1, 1), "short_k batch-major st4"),
    "K = 0": (_f(4, 10, 0), _f(4, 0, 12), "short_k n-major st16"),
}


@pytest.mark.parametrize("name", list(SK_CASES))
def test_short_k_plan_reads_the_layout_and_writes_c_once(name):
    """The label the plan reads from the strides; the tiling's limits; every
    element of C stored once, by a CTA whose members and span hold it, each
    16-byte run starting on 16 bytes."""
    a, b, label = SK_CASES[name]
    p = bx.plan_of(a, b)
    assert p.label == label
    G, M, N = int(np.prod(a.shape[:-2])), a.shape[-2], b.shape[-1]
    T, L = (M, N) if p.thin == "m" else (N, M)
    assert p.thin == ("m" if M <= N else "n") and T <= bx.SK_MAX_THIN and p.smem <= bx.SMEM_LIMIT
    width = 128 if p.store == 16 and p.layout != "batch-major" else 32  # l's a warp covers
    want = min(bx.SK_MIN_CTAS, max(-(-G * T * L // (8 * width)), -(-G * T // 8)))
    if p.layout == "batch-major":  # a lane a member, whole rows
        assert T == 1 and p.members == 32 and p.span == L
    assert p.members in bx.SK_MEMBERS
    assert p.span == L or (p.span % width == 0 and p.span < L and G < want)  # cut only to fill the SMs
    ctas = list(bx.short_k_ctas(p, G, M, N))
    assert len(ctas) == p.grid[0]
    assert all(len(cta.g) <= p.members and len(cta.l) <= p.span for cta in ctas)
    runs = np.array([(*run, cta.g.start, cta.g.stop, cta.l.start, cta.l.stop) for cta in ctas for run in cta.runs],
                    np.int64).reshape(-1, 8)
    c, n, step, store, g0, g1, l0, l1 = runs.T
    assert (store == p.store).all() and (p.store == 4 or ((c % 4 == 0) & (n % 4 == 0) & (step == 1)).all())
    which = np.repeat(np.arange(len(runs)), n)  # each stored element's run
    e = c[which] + step[which] * (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    g, l = e // (M * N), (e % N if p.thin == "m" else e // N % M)
    assert ((g0[which] <= g) & (g < g1[which]) & (l0[which] <= l) & (l < l1[which])).all()
    assert (np.bincount(e, minlength=G * M * N) == 1).all()


def _short_k_emulated(a, b, p):
    """C by the short-k plan's CTAs: each CTA's tile by the kernel's FMAs in
    float32 (k ascending; hi·hi into one sum, hi·lo then lo·hi into the
    other; a product of bf16 values is exact, so each step rounds once, as
    an FMA does), stored by its runs; NaN where no run stores, and the
    count of stores."""
    *batch, M, K = a.shape
    N = b.shape[-1]
    G = int(np.prod(batch))
    (ah, al), (bh, bl) = (bx.split_bf16(t.reshape(G, *t.shape[-2:])) for t in (a, b))
    c = torch.full((G, M, N), float("nan"))
    writes = torch.zeros(G * M * N, dtype=torch.int32)
    for cta in bx.short_k_ctas(p, G, M, N):
        g, l = slice(cta.g.start, cta.g.stop), slice(cta.l.start, cta.l.stop)
        rows, cols = (slice(None), l) if p.thin == "m" else (l, slice(None))
        hh = torch.zeros(len(cta.g), M if p.thin == "m" else len(cta.l), len(cta.l) if p.thin == "m" else N)
        x = torch.zeros_like(hh)
        for k in range(K):
            ahk, alk = ah[g, rows, k:k + 1], al[g, rows, k:k + 1]
            bhk, blk = bh[g, k:k + 1, cols], bl[g, k:k + 1, cols]
            hh = hh + ahk * bhk
            x = x + ahk * blk
            x = x + alk * bhk
        tile = torch.full((G, M, N), float("nan"))
        tile[g, rows, cols] = hh + x
        for run in cta.runs:
            e = torch.arange(run.c, run.c + run.n * run.step, run.step)
            c.view(-1)[e] = tile.view(-1)[e]
            writes[e] += 1
    return c.reshape(*batch, M, N), writes


SK_EMULATED = {
    "dF": lambda: (_r(2, 40, 1, 1), _r(2, 40, 250, 1).mT),
    "Ft": lambda: (_r(2, 250, 40).mT.unsqueeze(-1), _r(2, 40, 1, 1)),
    "the factor as B": lambda: (_r(2, 40, 1, 1), _r(2, 105, 40).mT.unsqueeze(-2)),
    "K = 16, thin M = 15": lambda: (_r(9, 15, 16), _r(9, 16, 70)),
    "K = 5, thin N = 4, m-major": lambda: (_r(3, 5, 1100).mT, _r(3, 5, 4)),
    "thin M, past one span, N % 4 = 1": lambda: (_r(3, 2, 3), _r(3, 3, 2501)),
    "batch-major, chunks past one": lambda: (_r(1030, 1, 20).permute(2, 0, 1), _r(20, 1, 1)),
    "the flagship's factor-10 product": lambda: (_r(2, 10, 10), _r(2, 10, 1000)),
    "a batch stride of 0": lambda: (_r(1, 1, 1).expand(20, 1, 1), _r(20, 1, 250)),
    "K = 0": lambda: (_r(4, 10, 0), _r(4, 0, 10)),
}


@pytest.mark.parametrize("name", list(SK_EMULATED))
def test_short_k_emulation_matches_the_plain_version(name):
    a, b = SK_EMULATED[name]()
    p = bx.plan_of(a, b)
    assert p.instance == "short_k"
    got, writes = _short_k_emulated(a, b, p)
    assert (writes == 1).all()
    (ah, al), (bh, bl) = bx.split_bf16(a), bx.split_bf16(b)
    untiled = torch.zeros(got.shape)
    x = torch.zeros(got.shape)
    for k in range(a.shape[-1]):  # the same FMAs on the whole product: the tiling changes no bit
        untiled = untiled + ah[..., k:k + 1] * bh[..., k:k + 1, :]
        x = x + ah[..., k:k + 1] * bl[..., k:k + 1, :]
        x = x + al[..., k:k + 1] * bh[..., k:k + 1, :]
    assert torch.equal(got, untiled + x)
    bound = a.shape[-1] * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert torch.all((got.double() - bx.bf16x3_mm_plain(a, b).double()).abs() <= 2.0 * bound)
