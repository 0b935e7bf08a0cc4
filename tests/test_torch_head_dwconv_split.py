"""The new designs of kernels 3 and 12, host side, on the CPU.

Kernel 3 (the shared-pool GEMV, the Mamba logits head) splits its segment
loop over a thread-block cluster: ``kernels.ops.shared_gemv_variant``
mirrors the split (every segment and column covered once, each output the
slices' ascending-segment sums added in slice order, shared memory within a
block's), and the plain version summed in that order matches the JAX
package's Pallas kernel (interpret mode).  Kernel 12 (the host-packed
dwconv) stages a table slice per block of channels:
``kernels.ops.dwconv_host_tiling`` mirrors its tiling (every ``(b, t, c)``
covered once).  The wrappers pass the design to the library and count it;
a forced design that cannot serve a shape raises.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``); ``kernels.ops`` checks at the library's
first launch of each shape that its split or tiling is this module's
mirror of it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.kernels import autotune as atn
from repro.kernels import ops as jops
from repro_torch.core import quantization as tq
from repro_torch.interop import to_torch
from repro_torch.kernels import build, ops

#: (B, G, O) the port launches kernel 3 at: the Mamba head at B = 4 and 1,
#: phase 10's scalar pool (group 1, G 1024, O 3072); then the ragged shapes
#: of the card checks and tests
HEAD_SHAPES = [(4, 384, 50288), (1, 384, 50288), (2, 384, 50288),
               (4, 1024, 3072)]
RAGGED_SHAPES = [(2, 6, 7), (4, 384, 16), (3, 5, 13), (5, 96, 200),
                 (1, 7, 130), (9, 3, 1), (2, 1, 5000), (4, 64, 130),
                 (7, 40, 1030)]
#: (M = B*T, C, V) the port launches kernel 12 at: the single-layer signal,
#: the card checks' ragged signals
DW_SHAPES = [(4 * 2048, 1792, 256), (3 * 9, 33, 16), (3 * 5, 33, 16),
             (4 * 4, 1792, 256), (1, 5, 4), (1000, 100, 64)]


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", HEAD_SHAPES + RAGGED_SHAPES)
def test_shared_split_covers_every_segment_and_column_once(itemsize, B, G,
                                                           O):
    """The cluster's slices partition [0, G) into ascending runs in rank
    order (so each accumulator adds its segments in ascending g and the
    slice sums in slice order), the tiles' lanes cover every column once,
    and the row chunks cover B."""
    sp = ops.shared_gemv_variant(B, G, O, itemsize)
    slices = ops.shared_gemv_slices(sp, G)
    assert len(slices) == sp.cluster
    order = [g for g0, g1 in slices for g in range(g0, g1)]
    assert order == list(range(G))
    nv = ops.SHARED_LANE_BYTES // itemsize
    assert sp.tile == sp.warps * 32 * nv
    cols = np.zeros(O, np.int32)
    for t in range(sp.tiles):
        for lane in range(sp.warps * 32):
            c = t * sp.tile + lane * nv + np.arange(nv)
            cols[c[c < O]] += 1
    assert (cols == 1).all()
    assert (sp.chunks - 1) * sp.rows < B <= sp.chunks * sp.rows


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", HEAD_SHAPES + RAGGED_SHAPES)
def test_shared_split_fits_a_block_and_a_cluster(itemsize, B, G, O):
    """A block's shared memory fits the card's 227 KB, its warps the
    declared most, its rows 1, 2 or 4; the cluster is a power of two up to
    16 and holds no slice under ``SHARED_MIN_SEGS`` segments unless it is
    a single block."""
    sp = ops.shared_gemv_variant(B, G, O, itemsize)
    assert ops.shared_gemv_smem_bytes(sp, G) <= ops.SMEM_LIMIT == 232448
    assert 1 <= sp.warps <= ops.SHARED_WARPS
    assert sp.rows in (1, 2, 4) and sp.rows <= max(B, 1) + 1
    assert 1 <= sp.cluster <= ops.SHARED_MAX_CLUSTER <= 16
    assert sp.cluster & (sp.cluster - 1) == 0
    if sp.cluster > 1:
        assert sp.cluster * ops.SHARED_MIN_SEGS <= G


def test_shared_split_at_the_head():
    """The Mamba head in float32: 1024-column tiles (a 4 KB piece of each
    pool row), 50 of them, each split over a cluster of 4 blocks of 96
    segments: 200 blocks, each holding 4 x 1024 float32 sums and 96 x 4
    pool rows; in bfloat16 2048-column tiles, a cluster of 8.  At B = 1 a
    block holds one row."""
    sp = ops.shared_gemv_variant(4, 384, 50288, 4)
    assert sp == ops.SharedSplit(rows=4, warps=8, cluster=4, tile=1024,
                                 tiles=50, chunks=1)
    assert ops.shared_gemv_smem_bytes(sp, 384) == 4 * 4 * 1024 + 96 * 4 * 4
    assert ops.shared_gemv_variant(4, 384, 50288, 2).cluster == 8
    assert ops.shared_gemv_variant(1, 384, 50288, 4).rows == 1


@pytest.mark.parametrize("M,C,V", DW_SHAPES)
@pytest.mark.parametrize("wide", [True, False])
def test_dwconv_tiling_covers_every_output_once(M, C, V, wide):
    """The staged dwconv's blocks (channel tile ``i % tiles``, row group
    ``i // tiles``) and, inside a block, its lanes (4 adjacent channels a
    lane where C is a multiple of 4 and ``wide``, else 1; rows in passes)
    cover every ``(row, channel)`` of the ``[M, C]`` output exactly once,
    and no lane reaches past channel C."""
    nv = 4 if wide and C % 4 == 0 else 1
    tl = ops.dwconv_host_tiling(M, C, V, 4)
    lanes = ops.DW_CHANS // nv        # lanes a row
    passes = ops.DW_THREADS // lanes  # rows a pass
    seen = np.zeros((M, C), np.int32)
    for i in range(tl.tiles * tl.groups):
        c0 = (i % tl.tiles) * ops.DW_CHANS
        g = i // tl.tiles
        r0, r1 = M * g // tl.groups, M * (g + 1) // tl.groups
        for tid in range(ops.DW_THREADS):
            cl = (tid % lanes) * nv
            if c0 + cl >= C:
                continue
            rows = np.arange(r0 + tid // lanes, r1, passes)
            ch = c0 + cl + np.arange(nv)
            assert ch[-1] < C
            seen[np.ix_(rows, ch)] += 1
    assert (seen == 1).all()
    assert tl.tiles * tl.groups <= ops.DW_TARGET_BLOCKS


@pytest.mark.parametrize("itemsize", [4, 2])
def test_dwconv_staged_serves_what_fits_a_block(itemsize):
    """The staged design holds a ``[DW_CHANS, V]`` slice: V = 256 (the
    signal's 2-bit, 4-tap tables) fits; V = 65536 (4 bits x 4 taps) keeps
    the direct design."""
    assert ops.dwconv_host_variant(256, itemsize) == "staged"
    assert ops.dwconv_host_tiling(8192, 1792, 256, itemsize).smem == \
        ops.DW_CHANS * 256 * itemsize <= ops.SMEM_LIMIT
    assert ops.dwconv_host_variant(1 << 16, itemsize) == "direct"


SPLIT_CASES = [  # B, G, group, bits, X, O, pool dtype, exact grid
    (4, 64, 2, 4, 64, 130, "float32", False),   # a cluster of 16, ragged O
    (4, 64, 2, 4, 64, 130, "float32", True),
    (3, 48, 2, 2, 12, 300, "float32", False),   # shared rows, 3 batch rows
    (1, 40, 2, 4, 40, 520, "bfloat16", False),  # one row a block
    (5, 32, 1, 4, 8, 70, "float32", True),      # two row chunks, group 1
]


@pytest.mark.parametrize("B,G,group,bits,X,O,dtype,exact", SPLIT_CASES)
def test_plain_in_split_order_matches_reference(B, G, group, bits, X, O,
                                                dtype, exact):
    """The plain version summed in the split's order (each slice's rows
    one at a time in ascending g, then the slices in order) against the
    JAX package's Pallas kernel: float32 within 1e-5 of the largest output
    and of each output (another order than the reference's one-hot
    contraction, over up to 64 rows), bit for bit on an exact grid
    (small-integer weights, power-of-two scale); bfloat16 within one
    rounding of the float32 sum (1e-2).  It is also the plain version's
    own sum, in another order."""
    rng = np.random.default_rng(B * 1000 + G * 10 + X)
    blocks = (rng.integers(-3, 4, size=(X, group, O)) if exact
              else rng.normal(size=(X, group, O))).astype(np.float32)
    w = blocks[rng.permutation(np.arange(G) % X)].reshape(G * group, O)
    scale = np.float32(0.5 if exact else 0.21)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    sh = jp.build_shared_grouped_tables(jnp.asarray(w), sj, jnp.float32(scale),
                                        group)
    pool = sh.pool.astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, G * group))).astype(np.float32)
    want = np.asarray(jops.pcilt_shared_gemv(jnp.asarray(x), pool, sh.seg_idx,
                                             sj, scale, group)
                      ).astype(np.float32)
    tpool = to_torch(pool)
    idx = to_torch(np.asarray(sh.seg_idx, np.int32))
    assert ops.shared_gemv_variant(B, G, O, tpool.element_size()).cluster > 1
    got = ops.shared_gemv_plain(torch.from_numpy(x), tpool, idx, st,
                                float(scale), group, split_order=True)
    plain = ops.shared_gemv_plain(torch.from_numpy(x), tpool, idx, st,
                                  float(scale), group)
    assert got.dtype == getattr(torch, dtype)
    got, plain = got.float().numpy(), plain.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        atol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=atol)


def test_plain_in_split_order_skips_out_of_range_pointers():
    """A pointer outside [0, X) adds nothing in the split's order too."""
    rng = np.random.default_rng(5)
    spec = tq.QuantSpec(4, True)
    pool = torch.from_numpy(rng.normal(size=(3, 256, 40)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 16 * 2)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 3, size=16).astype(np.int32))
    bad = idx.clone()
    bad[[3, 11]] = torch.tensor([-1, 3], dtype=torch.int32)
    got = ops.shared_gemv_plain(x, pool, bad, spec, 0.3, 2, split_order=True)
    full = ops.shared_gemv_plain(x, pool, idx, spec, 0.3, 2, split_order=True)
    only = sum(ops.shared_gemv_plain(x[:, 2 * g:2 * g + 2], pool, idx[g:g + 1],
                                     spec, 0.3, 2) for g in (3, 11))
    torch.testing.assert_close(got, full - only, rtol=1e-5, atol=1e-5)


class _FakeLibrary:
    """Stands in for the CUDA libraries: records each launch's arguments and
    answers the split and tiling queries from the mirrors (or from
    ``split`` / ``tiling``)."""

    def __init__(self):
        self.calls = []
        self.split = None
        self.tiling = None

    def pcilt_shared_gemv_split_config(self, cfg):
        cfg[:] = [ops.SHARED_ROWS, ops.SHARED_WARPS, ops.SHARED_LANE_BYTES,
                  ops.SHARED_LOADS, ops.SHARED_TARGET_BLOCKS,
                  ops.SHARED_MAX_CLUSTER, ops.SHARED_MIN_SEGS,
                  ops.SHARED_BLOCKS_PER_SM, ops.SM_SMEM_BYTES,
                  ops.BLOCK_RESERVED_SMEM]
        return 0

    def pcilt_shared_gemv_split_plan(self, B, G, O, itemsize, out):
        sp = self.split or ops.shared_gemv_variant(B, G, O, itemsize)
        out[:] = [*sp, ops.shared_gemv_smem_bytes(sp, G)]
        return 0

    def pcilt_dwconv1d_staged_config(self, cfg):
        cfg[:] = [ops.DW_CHANS, ops.DW_THREADS, ops.DW_UNROLL,
                  ops.DW_TARGET_BLOCKS]
        return 0

    def pcilt_dwconv1d_staged_plan(self, M, C, V, itemsize, out):
        out[:] = list(self.tiling or ops.dwconv_host_tiling(M, C, V,
                                                            itemsize))
        return 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: launches go to a
    :class:`_FakeLibrary`; the counts and first-launch checks are this
    test's own."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(ops, "_call", lambda name, fn, x, *args: fn(*args))
    monkeypatch.setattr(ops, "_SHARED_CHECKED", set())
    monkeypatch.setattr(ops, "_DW_CHECKED", set())
    monkeypatch.setattr(ops, "LAUNCHES", dict.fromkeys(ops.LAUNCHES, 0))
    monkeypatch.setattr(ops, "SHARED_GEMV_VARIANT_LAUNCHES",
                        {"split": 0, "direct": 0})
    monkeypatch.setattr(ops, "DWCONV_HOST_VARIANT_LAUNCHES",
                        {"staged": 0, "direct": 0})
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_launch_passes_and_counts_the_design(fake_card, dtype):
    """``pcilt_shared_gemv`` launches the split design (code 0) and counts
    it; ``_shared_gemv(variant="direct")`` passes the kept design's code
    (1); both count one launch of kernel 3."""
    spec = tq.QuantSpec(4, True)
    x = torch.zeros(4, 12)
    pool = torch.zeros(3, 256, 50, dtype=dtype)  # never read
    idx = torch.tensor([0, 2, 1, 5, 0, 1], dtype=torch.int32)
    ops.pcilt_shared_gemv(x, pool, idx, spec, 0.5, 2)
    ops._shared_gemv(x, pool, idx, spec, 0.5, 2, variant="direct")
    names = [n for n, _ in fake_card.calls]
    assert names == [f"pcilt_shared_gemv_{ops._TABLE_DTYPES[dtype]}"] * 2
    assert [a[-1] for _, a in fake_card.calls] == [0, 1]
    assert fake_card.calls[0][1][4:9] == (4, 6, 3, 256, 50)
    assert ops.LAUNCHES["shared_gemv"] == 2
    assert ops.SHARED_GEMV_VARIANT_LAUNCHES == {"split": 1, "direct": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dwconv_launch_passes_and_counts_the_design(fake_card, dtype):
    """``pcilt_dwconv1d`` launches the staged design (code 0) at V = 256
    and the kept one (1) at V = 65536, where nothing can be staged;
    ``variant="direct"`` forces the kept one at any V."""
    off = torch.zeros(2, 3, 5, dtype=torch.int32)
    ops.pcilt_dwconv1d(off, torch.zeros(5, 256, dtype=dtype))
    ops.pcilt_dwconv1d(off, torch.zeros(5, 1 << 16, dtype=dtype))
    ops._dwconv1d_host(off, torch.zeros(5, 256, dtype=dtype),
                       variant="direct")
    assert [a[3:] for _, a in fake_card.calls] == [
        (30, 5, 256, 0), (30, 5, 1 << 16, 1), (30, 5, 256, 1)]
    assert ops.LAUNCHES["dwconv1d_host"] == 3
    assert ops.DWCONV_HOST_VARIANT_LAUNCHES == {"staged": 1, "direct": 2}


def test_forced_designs_that_cannot_serve_a_shape_raise(fake_card):
    """The staged dwconv at V = 65536 and the kept head design over more
    offsets than a block holds raise before anything is launched; so does
    an unknown design.  Nothing falls back."""
    spec = tq.QuantSpec(4, True)
    off = torch.zeros(1, 2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be staged"):
        ops._dwconv1d_host(off, torch.zeros(3, 1 << 16), variant="staged")
    with pytest.raises(ValueError, match="unknown variant"):
        ops._dwconv1d_host(off, torch.zeros(3, 256), variant="split")
    x = torch.zeros(4, 2 * 20000)
    idx = torch.zeros(20000, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory of one block"):
        ops._shared_gemv(x, torch.zeros(1, 256, 8), idx, spec, 0.5, 2,
                         variant="direct")
    with pytest.raises(ValueError, match="unknown variant"):
        ops._shared_gemv(torch.zeros(4, 4), torch.zeros(1, 256, 8), idx[:2],
                         spec, 0.5, 2, variant="staged")
    assert fake_card.calls == []
    assert ops.LAUNCHES["shared_gemv"] == ops.LAUNCHES["dwconv1d_host"] == 0


def test_a_split_beyond_a_block_is_refused(fake_card):
    """Two million segments leave a slice of 125,000 in each of 16
    blocks: their pool rows alone need 2 MB of shared memory."""
    spec = tq.QuantSpec(4, True)
    G = 2_000_000
    sp = ops.shared_gemv_variant(4, G, 8, 4)
    assert ops.shared_gemv_smem_bytes(sp, G) > ops.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory a block"):
        ops.pcilt_shared_gemv(torch.zeros(4, G), torch.zeros(1, 16, 8),
                              torch.zeros(G, dtype=torch.int32), spec, 0.5, 1)
    assert fake_card.calls == []


def test_a_library_that_splits_or_tiles_otherwise_is_refused(fake_card):
    """The first launch of a shape asks the library for its split (or
    tiling); one that differs from the mirror raises before anything is
    launched."""
    spec = tq.QuantSpec(4, True)
    mine = ops.shared_gemv_variant(4, 64, 130, 4)
    fake_card.split = mine._replace(cluster=mine.cluster // 2)
    with pytest.raises(RuntimeError, match="kernels.ops as"):
        ops.pcilt_shared_gemv(torch.zeros(4, 128), torch.zeros(64, 256, 130),
                              torch.arange(64, dtype=torch.int32), spec, 0.5,
                              2)
    fake_card.tiling = ops.DwconvTiling(1, 1, 4096)
    with pytest.raises(RuntimeError, match="kernels.ops as"):
        ops.pcilt_dwconv1d(torch.zeros(4, 8, 33, dtype=torch.int32),
                           torch.zeros(33, 16))
    assert fake_card.calls == []


def test_forced_designs_on_the_cpu_run_the_plain_versions():
    """A design is forced on CUDA tensors only: on CPU tensors both
    wrappers run their plain versions whatever is forced, and no design is
    counted."""
    rng = np.random.default_rng(2)
    spec = tq.QuantSpec(4, True)
    pool = torch.from_numpy(rng.normal(size=(3, 256, 9)).astype(np.float32))
    idx = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    tabs = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    off = torch.from_numpy(rng.integers(-2, 18, size=(2, 3, 5))
                           .astype(np.int32))
    seen = (dict(ops.SHARED_GEMV_VARIANT_LAUNCHES),
            dict(ops.DWCONV_HOST_VARIANT_LAUNCHES))
    want = ops.shared_gemv_plain(x, pool, idx, spec, 0.3, 2)
    for v in ("split", "direct"):
        assert torch.equal(ops._shared_gemv(x, pool, idx, spec, 0.3, 2,
                                            variant=v), want)
    for v in ("staged", "direct"):
        assert torch.equal(ops._dwconv1d_host(off, tabs, variant=v),
                           ops.pcilt_dwconv1d(off, tabs))
    assert (dict(ops.SHARED_GEMV_VARIANT_LAUNCHES),
            dict(ops.DWCONV_HOST_VARIANT_LAUNCHES)) == seen
