"""The fused GEMV's split design, host side, on the CPU: the split
``kernels.ops.gemv_variant`` mirrors (every row, segment and column
covered once, slices ascending, shared memory and cluster within the
card's limits, the block counts at the decode shapes, the cluster grown
where a block's offsets would overflow and every other split as it was;
past the grid's 65535 rows of blocks the chunks go on in further planes,
and
past a 16-block cluster a block stages its offsets in slabs), the
wrappers' launches
(the same split with and without a plan, the design passed, the mirror
check), and the plain versions behind a forced design.  The host-packed
GEMV's split design (kernel 6, ``pcilt_gemv.cu`` over the same
``pcilt_split.cuh``) splits every shape as kernel 9 does.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``);
``kernels.ops`` checks at the library's first launch of each shape that its
split is this module's mirror of it.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import smem
from repro_torch.core.offsets import pack_offsets
from repro_torch.core.pcilt import build_grouped_tables
from repro_torch.core.quantization import QuantSpec, quantize
from repro_torch.kernels import build, ops

#: (B, G, O) a decode step launches: mamba2-130m's projections (wz/wx,
#: wB/wC, wdt, wo), the paired decode's, qwen3-0.6b's gate and down
#: projections and phase 10's plans; then the card tests' ragged shapes
DECODE_SHAPES = [(4, 384, 1536), (4, 384, 128), (4, 384, 24), (4, 768, 768),
                 (4, 192, 1536), (4, 192, 128), (4, 192, 24), (4, 384, 768),
                 (4, 512, 3072), (4, 1536, 1024), (4, 448, 3072),
                 (4, 576, 3072)]
RAGGED_SHAPES = [(3, 5, 24), (1, 7, 130), (5, 96, 200), (4, 160, 130),
                 (3, 7, 13), (1, 175, 130), (9, 3, 1), (2, 1, 5000)]
#: (B, G, O) whose split must fill at least 96 SMs (float32), and those
#: that must use more than one
FULL = [(4, 384, 1536), (4, 768, 768), (4, 512, 3072), (4, 192, 1536),
        (4, 384, 768)]
NARROW = [(4, 384, 128), (4, 384, 24), (4, 192, 128), (4, 192, 24)]
#: (B, G, O, itemsize) of the group-1 down projections (zamba2-7b,
#: llava-next-mistral-7b, deepseek-coder-33b) whose offsets overflow one
#: block unless the cluster grows, and a 1056-row call over 20000 segments
WIDE = [(32, 14336, 3584, 4), (64, 14336, 3584, 4), (64, 14336, 3584, 2),
        (32, 14336, 4096, 4), (64, 14336, 4096, 4), (64, 14336, 4096, 2),
        (16, 19200, 7168, 4), (32, 19200, 7168, 4), (32, 19200, 7168, 2),
        (64, 19200, 7168, 4), (64, 19200, 7168, 2), (1056, 20000, 8, 4)]
WIDE_SHAPES = list(dict.fromkeys((B, G, O) for B, G, O, _ in WIDE))
#: (B, G, O) past the ceilings the split once had and the reference never
#: did: a 16-block cluster's offsets past a block's shared memory (at 264
#: row chunks and at one), and more than 65535 row chunks
CEILING_SHAPES = [(1056, 300000, 8), (4, 230000, 8), (4 * 65536, 64, 8)]


def _blocks(split):
    return split.tiles * split.cluster * split.chunks


def _slices(split, G):
    """``[g0, g1)`` of every slot in slot order (block rank major, then
    warp, then the slot in its warp), as the split kernel cuts them."""
    S = split.cluster * split.warps * split.groups
    return [(s * G // S, (s + 1) * G // S) for s in range(S)]


def _summed_rows(split, B):
    """How often each row is summed: block ``(x, y, z)`` of the grid sums
    row chunk ``z * 65535 + y`` (none past the last)."""
    gx, gy, gz = ops.gemv_grid(split)
    assert gx == split.tiles * split.cluster
    assert gy <= ops.MAX_GRID_ROWS and gz <= ops.MAX_GRID_ROWS
    seen = np.zeros(B, np.int32)
    for z in range(gz):
        for y in range(gy):
            c = z * ops.MAX_GRID_ROWS + y
            if c < split.chunks:
                seen[c * ops.GEMV_ROWS:(c + 1) * ops.GEMV_ROWS] += 1
    return seen


def _slabbed(r0, r1, slab):
    """The slabs a block stages of its segments ``[r0, r1)``."""
    return [(t, min(t + slab, r1)) for t in range(r0, r1, slab)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", DECODE_SHAPES + RAGGED_SHAPES
                         + WIDE_SHAPES + CEILING_SHAPES)
def test_split_covers_every_segment_and_column_once(itemsize, B, G, O):
    """Each output tile's slots partition [0, G) into ascending slices, a
    block's slots cover exactly the segments whose offsets it packs
    (``[rank*G // cluster, (rank+1)*G // cluster)``), its slabs cover
    those once, every (segment, column) is summed by exactly one slot, and
    the grid's row chunks (on further planes past its rows) cover B
    once.
    A (segment, column) is summed once for each slice holding the segment
    times each tile lane holding the column, so the two counts are taken
    apart (a [G, O] count would take 0.55 GB at deepseek-coder-33b's)."""
    sp = ops.gemv_variant(B, G, O, itemsize)
    nv = ops.GEMV_LANE_BYTES // itemsize
    slices = _slices(sp, G)
    S = sp.cluster * sp.warps * sp.groups
    assert len(slices) == S
    assert slices[0][0] == 0 and slices[-1][1] == G
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in
               zip(slices, slices[1:]))
    sb = sp.warps * sp.groups
    slab = ops.gemv_slab(sp, G)
    staged = np.zeros(G, np.int32)
    for rank in range(sp.cluster):
        mine = slices[rank * sb:(rank + 1) * sb]
        r0, r1 = rank * G // sp.cluster, (rank + 1) * G // sp.cluster
        assert (mine[0][0], mine[-1][1]) == (r0, r1)
        for t0, t1 in _slabbed(r0, r1, slab):
            assert 0 < t1 - t0 <= slab
            staged[t0:t1] += 1
    assert (staged == 1).all()
    assert (_summed_rows(sp, B) == 1).all()
    segs, cols = np.zeros(G, np.int32), np.zeros(O, np.int32)
    for t in range(sp.tiles):
        c = np.array([t * sp.tile + sl * nv + k for sl in range(sp.lanes)
                      for k in range(nv)])
        cols[c[c < O]] += 1
    for g0, g1 in slices:
        segs[g0:g1] += 1
    assert (segs == 1).all() and (cols == 1).all()
    assert sp.tile == sp.lanes * nv and sp.tiles == -(-O // sp.tile)
    assert (sp.chunks - 1) * ops.GEMV_ROWS < B <= sp.chunks * ops.GEMV_ROWS


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", DECODE_SHAPES + RAGGED_SHAPES
                         + WIDE_SHAPES + CEILING_SHAPES)
def test_split_fits_a_block_and_a_cluster(itemsize, B, G, O):
    """A block's shared memory fits the card's 227 KB, its warps the
    declared most, its slots a warp; the cluster is a power of two within
    the declared limit (16, the non-portable size) and holds no slice
    under ``GEMV_MIN_SEGS`` segments unless it is a single block."""
    sp = ops.gemv_variant(B, G, O, itemsize)
    assert ops.gemv_smem_bytes(sp, G) <= ops.SMEM_LIMIT == 232448
    assert 1 <= sp.warps <= ops.GEMV_WARPS
    assert sp.lanes * sp.groups <= 32 and 32 // sp.lanes == sp.groups
    assert ops.GEMV_MAX_CLUSTER <= 16
    assert 1 <= sp.cluster <= ops.GEMV_MAX_CLUSTER
    assert sp.cluster & (sp.cluster - 1) == 0
    if sp.cluster > 1:
        assert sp.cluster * sp.warps * sp.groups * ops.GEMV_MIN_SEGS <= G
    assert "split" in ops.gemv_candidates(B, G, O, itemsize)


#: the splits each shape had before the cluster grew for wide offsets
#: (lanes, groups, warps, cluster, tile, tiles, chunks), in float32 then
#: bfloat16: the decode shapes (FULL and NARROW among them) ...
KEPT_SPLITS = {
    (4, 384, 1536, 4): (16, 2, 4, 16, 64, 24, 1),
    (4, 384, 128, 4): (16, 2, 4, 16, 64, 2, 1),
    (4, 384, 24, 4): (6, 5, 4, 16, 24, 1, 1),
    (4, 768, 768, 4): (16, 2, 4, 16, 64, 12, 1),
    (4, 192, 1536, 4): (16, 2, 4, 16, 64, 24, 1),
    (4, 192, 128, 4): (16, 2, 4, 16, 64, 2, 1),
    (4, 192, 24, 4): (6, 5, 4, 8, 24, 1, 1),
    (4, 384, 768, 4): (16, 2, 4, 16, 64, 12, 1),
    (4, 512, 3072, 4): (16, 2, 4, 8, 64, 48, 1),
    (4, 1536, 1024, 4): (16, 2, 4, 16, 64, 16, 1),
    (4, 448, 3072, 4): (16, 2, 4, 8, 64, 48, 1),
    (4, 576, 3072, 4): (16, 2, 4, 8, 64, 48, 1),
    (4, 384, 1536, 2): (16, 2, 4, 16, 128, 12, 1),
    (4, 384, 128, 2): (16, 2, 4, 16, 128, 1, 1),
    (4, 384, 24, 2): (3, 10, 4, 8, 24, 1, 1),
    (4, 768, 768, 2): (16, 2, 4, 16, 128, 6, 1),
    (4, 192, 1536, 2): (16, 2, 4, 16, 128, 12, 1),
    (4, 192, 128, 2): (16, 2, 4, 16, 128, 1, 1),
    (4, 192, 24, 2): (3, 10, 4, 4, 24, 1, 1),
    (4, 384, 768, 2): (16, 2, 4, 16, 128, 6, 1),
    (4, 512, 3072, 2): (16, 2, 4, 16, 128, 24, 1),
    (4, 1536, 1024, 2): (16, 2, 4, 16, 128, 8, 1),
    (4, 448, 3072, 2): (16, 2, 4, 16, 128, 24, 1),
    (4, 576, 3072, 2): (16, 2, 4, 16, 128, 24, 1)}
#: ... and, for the full sweep of ``analysis.smem`` (every registered
#: config's widths at B 1 to 64), the shapes whose split fitted a block and
#: the sha256 of their sorted ``repr([((B, G, O, itemsize), split), ...])``
KEPT_SWEEP = (1713, "705211882542d1e1374639862c539f6005bf33066bc3b29f28d2"
                    "eda65570a97c")


def test_a_split_that_fitted_is_unchanged():
    """The cluster grows only where a block's offsets overflowed: every
    decode shape (FULL and NARROW among them) and every shape of the full
    sweep that fitted before keeps its split exactly."""
    import hashlib

    from repro_torch.analysis import smem

    assert {k[:3] for k in KEPT_SPLITS} >= set(FULL + NARROW)
    for (B, G, O, es), want in KEPT_SPLITS.items():
        assert tuple(ops.gemv_variant(B, G, O, es)) == want, (B, G, O, es)
    fit = []
    for s in smem._gemv_shapes("full"):
        k = (s["B"], s["G"], s["O"], s["itemsize"])
        sp = ops.gemv_variant(*k)
        if k not in WIDE:
            fit.append((k, tuple(sp)))
    digest = hashlib.sha256(repr(sorted(fit)).encode()).hexdigest()
    assert (len(fit), digest) == KEPT_SWEEP


@pytest.mark.parametrize("B,G,O,itemsize", WIDE)
def test_wide_offsets_grow_the_cluster(B, G, O, itemsize):
    """Where the row chunks alone fill the grid, a block would stage all G
    offsets, which one block cannot hold at once: the cluster doubles
    (here to 2) until each block's fit in one slab, no further."""
    sp = ops.gemv_variant(B, G, O, itemsize)
    one = sp._replace(cluster=1)
    assert ops.gemv_slab(one, G) < G
    assert sp.cluster == 2 and ops.gemv_slab(sp, G) == -(-G // 2)
    assert ops.gemv_smem_bytes(sp, G) <= ops.SMEM_LIMIT
    assert ops.gemv_candidates(B, G, O, itemsize) == ["split"]


def test_split_shared_memory_layout():
    """wz in float32: 16-lane slots of 64 columns, two a warp, 8 a block, a
    cluster of 16 blocks on each of 24 output tiles; a block holds 8 slots
    of 4 rows x 64 float32 partial sums, then the offsets of 384 / 16
    segments x 4 rows."""
    sp = ops.gemv_variant(4, 384, 1536, 4)
    assert sp == ops.GemvSplit(lanes=16, groups=2, warps=4, cluster=16,
                               tile=64, tiles=24, chunks=1)
    assert ops.gemv_smem_bytes(sp, 384) == 8 * 4 * 64 * 4 + 24 * 4 * 4


@pytest.mark.parametrize("B,G,O", FULL)
def test_split_fills_the_card_at_wide_decode_shapes(B, G, O):
    """wz/wx, wo, the paired wz and wo and qwen3-0.6b's gate: at least 96
    blocks in float32 (the kept design ran 12, 6, 12, 6 and 24)."""
    assert _blocks(ops.gemv_variant(B, G, O, 4)) >= 96


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", NARROW)
def test_split_spreads_narrow_projections(itemsize, B, G, O):
    """wB/wC (O 128) and wdt (O 24) run on more than one SM in float32
    (the kept design ran one block), and a 24-column row puts several
    slots in a warp instead of idling lanes."""
    sp = ops.gemv_variant(B, G, O, itemsize)
    if itemsize == 4:
        assert _blocks(sp) > 1
    if O == 24:
        assert sp.groups > 1 and sp.lanes * sp.groups >= 30


def test_split_depends_on_the_shape_alone():
    """The same shape and dtype give the same split, whatever the batch
    rows within one chunk."""
    assert ops.gemv_variant(1, 384, 1536, 4) == ops.gemv_variant(4, 384,
                                                                 1536, 4)
    assert ops.gemv_variant(5, 384, 1536, 4).chunks == 2


class _FakeLibrary:
    """Stands in for the CUDA library: records each launch's arguments and
    answers the split queries from the mirror (or from ``plan``)."""

    def __init__(self, plan=None):
        self.calls = []
        self.plan = plan

    def pcilt_gemv_split_config(self, cfg):
        cfg[:] = [ops.GEMV_ROWS, ops.GEMV_WARPS, ops.GEMV_SEG_BATCH,
                  ops.GEMV_TARGET_BLOCKS, ops.GEMV_MAX_CLUSTER,
                  ops.GEMV_MIN_SEGS, ops.GEMV_MAX_LANES,
                  ops.GEMV_LANE_BYTES]
        return 0

    def pcilt_gemv_split_plan(self, B, G, O, itemsize, out):
        sp = self.plan or ops.gemv_variant(B, G, O, itemsize)
        out[:] = [*sp, ops.gemv_smem_bytes(sp, G), ops.gemv_slab(sp, G),
                  ops.gemv_planes(sp)]
        return 0

    def pcilt_gemv_staged_config(self, cfg):
        cfg[:] = ops.STAGED_GEMV_CONFIG
        return 0

    def pcilt_gemv_staged_plan(self, B, G, V, O, itemsize, out):
        p = ops.gemv_staged_plan(B, G, V, O, itemsize)
        out[:] = [int(p.wide), p.rpt, p.rows, p.cols, p.rtiles, p.ctiles,
                  p.cluster, ops.gemv_staged_slab(p, G, V),
                  ops.gemv_staged_smem_bytes(p, G, V),
                  ops.gemv_staged_planes(p)]
        return 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: launches go to a
    :class:`_FakeLibrary`; the counts are this test's own."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(ops, "_call", lambda name, fn, x, *args: fn(*args))
    monkeypatch.setattr(ops, "_GEMV_CHECKED", set())
    monkeypatch.setattr(ops, "LAUNCHES", dict.fromkeys(ops.LAUNCHES, 0))
    monkeypatch.setattr(ops, "_GEMV_STAGED_CHECKED", set())
    monkeypatch.setattr(ops, "GEMV_VARIANT_LAUNCHES",
                        {"split": 0, "staged": 0, "direct": 0})
    return lib


def _fused_args(call):
    """(entry point, (B, G, O), variant) of a recorded fused, plan or
    staged launch (the staged library's entry point: variant 2)."""
    name, args = call
    if name.startswith("pcilt_gemv_plan"):
        return name.replace("plan", "*"), args[4:7], args[-1]
    if name.startswith("pcilt_gemv_staged"):
        return name.replace("staged", "*"), args[4:7], 2
    return name.replace("fused", "*"), args[4:7], args[-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,O", [(256, 384), (1024, 96), (42, 24)])
def test_split_is_the_same_with_and_without_a_plan(fake_card, dtype, n, O):
    """Kernel 11 on a permutation plan and kernel 9 on the permuted x
    launch with the same (B, G, O), dtype and design, so the library
    splits them alike and sums them in one order (the card test of the
    permutation holds them bit-equal)."""
    from repro_torch.core.offsets import SegmentPlan

    rng = np.random.default_rng(n)
    spec = QuantSpec(4, True)
    perm = rng.permutation(n).astype(np.int32)
    plan = SegmentPlan(perm.reshape(-1, 2))
    tabs = torch.empty((n // 2, 256, O), dtype=dtype)  # never read
    x = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32))
    ops.pcilt_fused_gemv_plan(x, tabs, plan.on("cpu"), spec, 0.2, 2)
    ops.pcilt_fused_gemv(x[:, torch.from_numpy(perm).long()].contiguous(),
                         tabs, spec, 0.2, 2)
    (pn, pshape, pv), (fn, fshape, fv) = map(_fused_args, fake_card.calls)
    assert pn == fn == f"pcilt_gemv_*_{ops._TABLE_DTYPES[dtype]}"
    assert pshape == fshape == (4, n // 2, O) and pv == fv == 0
    assert ops.LAUNCHES["gemv_plan"] == ops.LAUNCHES["fused_gemv"] == 1
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 2, "staged": 0,
                                         "direct": 0}


def test_forced_design_reaches_the_library(fake_card):
    """Inside ``_gemv_forced("direct")`` each of the five launches passes
    the kept design's code (1) and counts as "direct"; outside, the split
    design's (0); ``variant=`` of ``_launch_gemv`` overrides both."""
    spec = QuantSpec(2, True)
    x = torch.zeros(4, 8)
    stack = torch.zeros(3, 2, 256, 5)   # [L, G, V, O] at group 4
    pairs = torch.zeros(2, 3, 256, 5)   # [G2, L, V2, O] at group 2

    def five():
        ops.pcilt_fused_gemv_stacked(x, stack, 1, spec, 0.5, 4,
                                     with_stats=True)
        ops.pcilt_fused_gemv(x, stack[0], spec, 0.5, 4)
        ops.pcilt_fused_gemv_paired(x, pairs[:, 0].contiguous(), spec, 0.5,
                                    2)
        ops.pcilt_fused_gemv_paired_stacked(x, pairs, 2, spec, 0.5, 2)
        ops.pcilt_fused_gemv_plan(x, stack[0], torch.arange(
            8, dtype=torch.int32).reshape(2, 4), spec, 0.5, 4)

    five()
    with ops._gemv_forced("direct"):
        five()
    assert [_fused_args(c)[2] for c in fake_card.calls] == [0] * 5 + [1] * 5
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 5, "staged": 0,
                                         "direct": 5}
    ops._launch_gemv("fused_gemv", x, stack[0], 2, 5, 4, 256 * 5, 0, spec,
                     0.5, False, variant="direct")
    assert _fused_args(fake_card.calls[-1])[2] == 1
    with pytest.raises(ValueError, match="unknown fused GEMV variant"):
        ops._launch_gemv("fused_gemv", x, stack[0], 2, 5, 4, 256 * 5, 0,
                         spec, 0.5, False, variant="tiled")


def test_a_library_that_splits_otherwise_is_refused(fake_card):
    """The first launch of a shape asks the library for its split; one
    that differs from the mirror raises before anything is launched."""
    mine = ops.gemv_variant(4, 4, 5, 4)
    assert mine == ops.GemvSplit(2, 16, 1, 1, 8, 1, 1)
    fake_card.plan = mine._replace(cluster=2)
    spec = QuantSpec(4, True)
    with pytest.raises(RuntimeError, match="kernels.ops as"):
        ops.pcilt_fused_gemv(torch.zeros(4, 8), torch.zeros(4, 256, 5), spec,
                             0.5, 2)
    assert fake_card.calls == []


def test_a_wide_split_reaches_the_library(fake_card):
    """264 row chunks over 20000 segments: a single block's offsets would
    need 320 KB of shared memory, so the cluster grows to 2 blocks (each
    stages 10000 segments, 164 KB) and the split launch reaches the
    library, its plan checked against the mirror first."""
    spec = QuantSpec(4, True)
    x = torch.zeros(1056, 2)
    sp = ops.gemv_variant(1056, 20000, 8, 4)
    assert sp.cluster == 2 and sp.chunks == 264
    assert ops.gemv_smem_bytes(sp, 20000) <= ops.SMEM_LIMIT
    ops._launch_gemv("fused_gemv", x, torch.zeros(1, 256, 8), 20000, 8, 2,
                     256 * 8, 0, spec, 0.5, False)
    assert [_fused_args(c) for c in fake_card.calls] == \
        [("pcilt_gemv_*_f32", (1056, 20000, 8), 0)]
    assert (264, 20000, 8, 4) in ops._GEMV_CHECKED
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 1, "staged": 0,
                                         "direct": 0}


@pytest.mark.parametrize("B,G", [(1056, 300000), (4, 230000),
                                 (4 * 65536, 64)])
def test_a_split_beyond_a_cluster_reaches_the_library(fake_card, B, G):
    """A 16-block cluster stages ceil(G / 16) offsets a block: past ~224,000
    segments they overflow its shared memory, so it stages them in slabs;
    past 65535 row chunks the grid's rows run out, so the chunks go on in
    a second plane of the grid.  The plan fits a block (covering every row, segment
    and column once: ``test_split_covers_every_segment_and_column_once``
    at these shapes) and the split launch reaches the library, its plan
    (the slab among it) checked against the mirror first, as the
    reference computes these shapes."""
    spec = QuantSpec(4, True)
    x = torch.zeros(B, 2)
    sp = ops.gemv_variant(B, G, 8, 4)
    slab = ops.gemv_slab(sp, G)
    assert sp.chunks > ops.MAX_GRID_ROWS or (
        sp.cluster == ops.GEMV_MAX_CLUSTER and slab < -(-G // sp.cluster))
    assert ops.gemv_smem_bytes(sp, G) <= ops.SMEM_LIMIT
    assert ops.gemv_candidates(B, G, 8, 4)[0] == "split"
    ops._launch_gemv("fused_gemv", x, torch.zeros(1, 256, 8), G, 8, 2,
                     256 * 8, 0, spec, 0.5, False)
    assert [_fused_args(c) for c in fake_card.calls] == \
        [("pcilt_gemv_*_f32", (B, G, 8), 0)]
    assert (sp.chunks, G, 8, 4) in ops._GEMV_CHECKED
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 1, "staged": 0,
                                         "direct": 0}


def test_unknown_forced_design_is_refused():
    with pytest.raises(ValueError, match="unknown fused GEMV variant"):
        with ops._gemv_forced("tiled"):
            pass


@pytest.mark.parametrize("variant", ["split", "direct"])
def test_a_forced_design_on_the_cpu_runs_the_plain_version(variant):
    """A design is forced on CUDA tensors only: on CPU tensors each
    wrapper runs its plain version whatever is forced, and no design is
    counted."""
    rng = np.random.default_rng(3)
    spec, group = QuantSpec(4, True), 2
    w = torch.from_numpy(rng.normal(size=(2, 24, 13)).astype(np.float32))
    tabs = torch.stack([build_grouped_tables(w[l], spec, 0.2, group)
                        for l in range(2)])
    x = torch.from_numpy(rng.normal(size=(3, 24)).astype(np.float32))
    seen = dict(ops.GEMV_VARIANT_LAUNCHES)
    want = ops.gemv_stacked_plain(x, tabs, 1, spec, 0.2, group,
                                  with_stats=True)
    with ops._gemv_forced(variant):
        got = ops.pcilt_fused_gemv_stacked(x, tabs, 1, spec, 0.2, group,
                                           with_stats=True)
        plain = ops.pcilt_fused_gemv(x, tabs[1], spec, 0.2, group)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(plain, want[0])
    assert ops.GEMV_VARIANT_LAUNCHES == seen


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,O", DECODE_SHAPES + RAGGED_SHAPES
                         + WIDE_SHAPES + CEILING_SHAPES)
def test_kernel_6_splits_a_shape_as_kernel_9(itemsize, B, G, O):
    """Kernel 6's split design launches kernel 9's split of the same (M,
    G, O, itemsize): the verifier's models of the two launches differ in
    the kernels' names only (grid, block, shared memory, cluster, the slab
    kernel where a block's segments overflow a slab), both cover every
    row, segment and column once, and the host design admits the shape
    at any V."""
    s9 = {"B": B, "G": G, "O": O, "itemsize": itemsize}
    for V in (16, 256, 1 << 16):
        s6 = {"M": B, "G": G, "V": V, "O": O, "itemsize": itemsize}
        (l9,) = smem._gemv_launches(s9, "split")
        (l6,) = smem._gemv_host_launches(s6, "split")
        assert (l6.grid, l6.block, l6.smem, l6.cluster) == \
            (l9.grid, l9.block, l9.smem, l9.cluster)
        assert l6.kernel == l9.kernel.replace("gemv_", "gemv_host_", 1)
        assert smem._gemv_host_cover(s6, "split") == \
            smem._gemv_cover(s9, "split") == []
        assert "split" in ops.gemv_host_candidates(B, G, V, O, itemsize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_6_and_kernel_9_check_one_split(fake_card, monkeypatch,
                                               dtype):
    """Kernel 9 on x and kernel 6 on x's packed offsets, at the same (B, G,
    O) and dtype: both check the library's split of the shape against the
    same ``gemv_variant`` split before their launch, each in its own
    library's record, and each launches its split design."""
    seen = []
    real = ops._check_gemv_split

    def check(lib, B, G, O, es, split, checked=None):
        seen.append((B, G, O, es, split))
        return real(lib, B, G, O, es, split, checked)

    monkeypatch.setattr(ops, "_check_gemv_split", check)
    monkeypatch.setattr(ops, "_HOST_SPLIT_CHECKED", set())
    monkeypatch.setattr(ops, "GEMV_HOST_VARIANT_LAUNCHES",
                        {"split": 0, "staged": 0, "direct": 0})
    spec, group = QuantSpec(2, True), 2
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    tabs = torch.zeros(64, 16, 96, dtype=dtype)
    off = pack_offsets(quantize(x, spec, 0.5), spec.bits, group)
    ops.pcilt_fused_gemv(x, tabs, spec, 0.5, group)
    ops.pcilt_gemv(off, tabs)
    es = tabs.element_size()
    sp = ops.gemv_variant(4, 64, 96, es)
    assert seen == [(4, 64, 96, es, sp)] * 2
    assert (sp.chunks, 64, 96, es) in ops._GEMV_CHECKED
    assert (sp.chunks, 64, 96, es) in ops._HOST_SPLIT_CHECKED
    assert [c[1][-1] for c in fake_card.calls] == [0, 2]  # the split codes
    assert ops.GEMV_VARIANT_LAUNCHES["split"] == 1
    assert ops.GEMV_HOST_VARIANT_LAUNCHES["split"] == 1


@pytest.mark.parametrize("M", [1, 4, 1023, 2048])
def test_a_forced_host_split_on_the_cpu_runs_the_plain_version(M):
    """A design is forced on CUDA tensors only: on CPU tensors kernel 6
    with the split forced runs its plain version (offsets out of range
    adding nothing), and no design is counted."""
    rng = np.random.default_rng(M)
    G, V, O = 9, 64, 13
    tabs = torch.from_numpy(rng.normal(size=(G, V, O)).astype(np.float32))
    off = rng.integers(0, V, size=(M, G)).astype(np.int32)
    off.reshape(-1)[::5] = -1
    off.reshape(-1)[1::7] = V
    off.reshape(-1)[2::11] = 2 ** 31 - 1
    off = torch.from_numpy(off)
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    got = ops._gemv_host(off, tabs, variant="split")
    assert torch.equal(got, ops.gemv_host_plain(off, tabs))
    valid = (off >= 0) & (off < V)
    want = torch.stack([tabs[g][off[:, g].clamp(0, V - 1)]
                        * valid[:, g, None] for g in range(G)]).sum(0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert dict(ops.GEMV_HOST_VARIANT_LAUNCHES) == seen
