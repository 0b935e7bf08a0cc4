"""Kernel 9's staged design, host side, on the CPU: the plan
``kernels.ops.gemv_staged_plan`` mirrors (every row, segment and column
covered once, ranks ascending, slabs within a rank, shared memory within
227 KB, a cluster of at most 16), the chooser between the split and the
staged design (every B = 4 decode launch keeps the split), the wrapper's
launch of a forced or chosen staged design (the library's plan checked
against the mirror first, a library that plans otherwise refused, the
plain version on CPU tensors), and the plain version at many rows against
the reference's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
``test_fused_gemv_staged_matches_plain_twice``, ``chip_smoke.py`` phase
3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.pcilt_fused import pcilt_fused_gemv_pallas
from repro_torch.core.pcilt import build_grouped_tables
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels import ops

from test_torch_gemv_split import (DECODE_SHAPES, _fused_args,  # noqa: F401
                                   fake_card)

#: (B, G, V, O) of kernel 9 at many rows: llava-next-mistral-7b's and
#: deepseek-coder-33b's group-1 down projections, qwen3-0.6b's gate at a
#: 4 x 192-token prefill, ragged shapes, and past the grid's rows of tiles
STAGED_SHAPES = [(32, 14336, 16, 4096), (16, 19200, 16, 7168),
                 (32, 19200, 16, 7168), (768, 512, 256, 3072),
                 (4096, 14336, 16, 4096), (64, 256, 16, 96),
                 (40, 96, 16, 13), (300, 40, 16, 520), (768, 64, 256, 200),
                 (5, 7, 4, 3), (262148, 64, 256, 64), (262148, 64, 16, 64),
                 (4, 230000, 16, 64), (8388609, 16, 16, 8)]


def _rows_covered(plan, B):
    """How often each row is summed: block ``(x, y, z)`` of the grid sums
    row tile ``z * 65535 + y`` (none past the last); counted by tiles, so
    a few million rows take no time."""
    gx, gy, gz = ops.gemv_staged_grid(plan)
    assert gx == plan.ctiles * plan.cluster
    assert gy <= ops.MAX_GRID_ROWS and gz <= ops.MAX_GRID_ROWS
    tiles = [z * ops.MAX_GRID_ROWS + y for z in range(gz) for y in range(gy)]
    tiles = [t for t in tiles if t < plan.rtiles]
    assert sorted(tiles) == list(range(plan.rtiles))
    return [(t * plan.rows, min(B, (t + 1) * plan.rows)) for t in tiles]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,V,O", STAGED_SHAPES)
def test_staged_plan_covers_every_row_segment_and_column_once(itemsize, B,
                                                               G, V, O):
    """The row tiles partition [0, B) (on further planes past the grid's
    rows), the column tiles [0, O), the cluster's ranks [0, G) in
    ascending order, and each rank's slabs its segments; a block's rows
    are its threads' (rows a thread x rows a warp reads at once x 16
    warps)."""
    p = ops.gemv_staged_plan(B, G, V, O, itemsize)
    rows = _rows_covered(p, B)
    assert rows[0][0] == 0 and rows[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    cols = [(t * p.cols, min(O, (t + 1) * p.cols)) for t in range(p.ctiles)]
    assert cols[-1][1] == O and all(a < b for a, b in cols)
    assert p.cols * itemsize == (512 if p.wide else 128)
    assert p.wide == (V <= ops.STAGED_GEMV_WIDE_MAX_V)
    assert p.rows == p.rpt * (1 if p.wide else 4) \
        * ops.STAGED_GEMV_THREADS[p.wide] // 32
    assert p.rpt in ops.staged_gemv_rpts(itemsize)
    ranks = [(r * G // p.cluster, (r + 1) * G // p.cluster)
             for r in range(p.cluster)]
    assert ranks[0][0] == 0 and ranks[-1][1] == G
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranks,
                                                              ranks[1:]))
    slab = ops.gemv_staged_slab(p, G, V)
    for r0, r1 in ranks:
        slabs = [(t, min(t + slab, r1)) for t in range(r0, r1, slab)]
        assert sum(b - a for a, b in slabs) == r1 - r0
        assert all(0 < b - a <= slab for a, b in slabs)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,G,V,O", STAGED_SHAPES)
def test_staged_plan_fits_a_block_and_a_cluster(itemsize, B, G, V, O):
    """A block's shared memory (the ring or the partial sums, then a
    slab's offset bytes and row masks) fits 227 KB, and a wide block's
    two fit an SM (its ``__launch_bounds__`` asks two); the cluster is a
    power of two of at most 16 blocks, none under 16 segments (unless G
    is); every offset fits a byte; the row tile holds every row up to the
    largest tile; at most 64 float32 sums a thread."""
    p = ops.gemv_staged_plan(B, G, V, O, itemsize)
    smem = ops.gemv_staged_smem_bytes(p, G, V)
    assert smem <= ops.STAGED_GEMV_SMEM[p.wide] <= ops.SMEM_LIMIT
    assert ops.STAGED_GEMV_BLOCKS[p.wide] * (smem + ops.BLOCK_RESERVED_SMEM) \
        <= ops.SM_SMEM_BYTES
    ring = ops.STAGED_GEMV_RING[p.wide] * V * p.cols * itemsize
    part = p.rows * p.cols * 4 if p.cluster > 1 else 0
    slab = ops.gemv_staged_slab(p, G, V)
    assert smem == max(ring, part) + slab * (p.rows + 4 * -(-V // 32))
    assert 1 <= p.cluster <= 16 and p.cluster & (p.cluster - 1) == 0
    assert p.cluster == 1 or G // p.cluster >= ops.STAGED_GEMV_MIN_SEGS
    assert V <= ops.STAGED_GEMV_MAX_V
    largest = max(ops.staged_gemv_rpts(itemsize))
    assert p.rows >= B or p.rpt == largest
    assert p.rpt * (p.cols * itemsize // (32 if p.wide else 8)) \
        // itemsize <= ops.STAGED_GEMV_MAX_SUMS == 32


def test_staged_plans_of_the_named_shapes():
    """llava's down projection at B 32 holds its 32 rows in one tile of 32,
    128 float32 columns a block and 16 ranks (512 blocks, four an SM, two
    slabs a rank); qwen3-0.6b's gate at 768 rows two 512-row tiles of 32
    columns in 2 ranks (384 blocks, one an SM, two slabs); a row tile every
    32 rows at 4096 rows of V 16."""
    p = ops.gemv_staged_plan(32, 14336, 16, 4096, 4)
    assert p == ops.GemvStaged(True, 8, 32, 128, 1, 32, 16)
    assert ops.gemv_staged_grid(p) == (512, 1, 1)
    assert ops.gemv_staged_slab(p, 14336, 16) < 14336 // 16
    p = ops.gemv_staged_plan(768, 512, 256, 3072, 4)
    assert p == ops.GemvStaged(False, 8, 512, 32, 2, 96, 2)
    assert ops.gemv_staged_slab(p, 512, 256) < 256
    p = ops.gemv_staged_plan(4096, 14336, 16, 4096, 4)
    assert (p.rows, p.rtiles, p.cluster) == (32, 128, 1)


#: (G, V, O) of every fused GEMV a B = 4 decode step launches: mamba2-130m
#: (4-bit group 2 and paired), qwen3-0.6b's MLP and the plans, and kernel
#: 9 at the group-1 down projections of llava and deepseek-coder-33b
DECODE_V = [(G, 256, O) for _, G, O in DECODE_SHAPES] + [
    (14336, 16, 4096), (19200, 16, 7168), (14336, 16, 3584)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("G,V,O", DECODE_V)
def test_every_decode_launch_keeps_the_split(itemsize, G, V, O):
    """At B = 4 kernel 9's chooser keeps the split; kernels 1, 8, 10 and 11
    (no ``V``: the staged design is not admitted) take it too."""
    assert ops.gemv_fused_variant(4, G, V, O, itemsize) == "split"
    assert ops.gemv_candidates(4, G, O, itemsize, V)[0] == "split"
    assert "staged" in ops.gemv_candidates(4, G, O, itemsize, V)
    assert "staged" not in ops.gemv_candidates(4, G, O, itemsize)
    assert ops.gemv_candidates(4, G, O, itemsize)[0] == "split"


@pytest.mark.parametrize("B,G,V,O,itemsize", [
    (32, 14336, 16, 4096, 4), (16, 14336, 16, 4096, 4),
    (16, 19200, 16, 7168, 4), (8, 19200, 16, 7168, 4),
    (32, 19200, 16, 7168, 2), (32, 14336, 16, 4096, 2),
    (768, 1536, 16, 1024, 4), (4096, 512, 256, 3072, 4)])
def test_many_rows_take_the_staged_design(B, G, V, O, itemsize):
    """Where the sweep measured the staged design faster: llava's down
    projection from B 16 (float32) or 32 (bfloat16), deepseek's from B 8
    (float32), qwen3-0.6b's down projection at group 1 over a 768-row
    prefill, its gate at 4096 rows (float32); a V past a byte does not
    admit it."""
    assert ops.gemv_fused_variant(B, G, V, O, itemsize) == "staged"
    assert ops.gemv_candidates(B, G, O, itemsize, V) == ["staged", "split"]
    assert "staged" not in ops.gemv_candidates(B, G, O, itemsize, 512)


@pytest.mark.parametrize("B,G,V,O,itemsize", [
    (8, 14336, 16, 4096, 4), (16, 14336, 16, 4096, 2),
    (8, 19200, 16, 7168, 2), (768, 512, 256, 3072, 4),
    (4096, 512, 256, 3072, 2), (256, 512, 256, 3072, 4),
    (4, 14336, 16, 4096, 4), (4, 4096, 16, 14336, 4),
    (64, 3072, 16, 1024, 4), (256, 3072, 16, 1024, 4),
    (768, 3072, 16, 1024, 2)])
def test_the_split_keeps_what_it_wins(B, G, V, O, itemsize):
    """Where the sweep measured the split faster (or within 20%), it stays:
    llava's down projection at B 8 (float32) and 16 (bfloat16), deepseek's
    at B 8 (bfloat16), qwen3-0.6b's gate up to 768 rows (float32) and at
    4096 (bfloat16, its rows' slices served by L2), its down projection at
    group 1 up to 256 rows (float32) and 768 (bfloat16); and below 8 rows,
    a wide O (llava's up projection at group 1) too."""
    assert ops.gemv_fused_variant(B, G, V, O, itemsize) == "split"
    assert ops.gemv_candidates(B, G, O, itemsize, V)[:2] == ["split",
                                                           "staged"]


def _gemv_call(B, G, group, O, dtype=torch.float32):
    spec = QuantSpec(4, True)
    x = torch.zeros(B, G * group)
    tabs = torch.zeros(G, 1 << (spec.bits * group), O, dtype=dtype)
    return x, tabs, spec


def test_a_chosen_staged_design_reaches_the_library(fake_card):
    """Kernel 9 at llava's down projection's width (B 32, group 1, O 4096;
    64 segments): the chooser's staged design reaches the library with
    code 2, its plan (and the constants) checked against the mirror first
    and counted as "staged"."""
    x, tabs, spec = _gemv_call(32, 64, 1, 4096)
    ops.pcilt_fused_gemv(x, tabs, spec, 0.5, 1)
    assert [_fused_args(c) for c in fake_card.calls] == \
        [("pcilt_gemv_*_f32", (32, 64, 4096), 2)]
    p = ops.gemv_staged_plan(32, 64, 16, 4096, 4)
    assert "config" in ops._GEMV_STAGED_CHECKED
    assert (p.rows, p.rtiles, 64, 16, 4096, 4) in ops._GEMV_STAGED_CHECKED
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 0, "staged": 1,
                                         "direct": 0}
    assert ops.LAUNCHES["fused_gemv"] == 1


def test_a_forced_staged_design_reaches_the_library(fake_card):
    """``_gemv_forced("staged")`` moves a B = 4 kernel-9 launch, and its
    counter launch, to the staged design (code 2); kernels 1, 8, 10 and
    11 refuse it before anything is launched."""
    x, tabs, spec = _gemv_call(4, 6, 2, 5)
    with ops._gemv_forced("staged"):
        ops.pcilt_fused_gemv(x, tabs, spec, 0.5, 2)
        ops._launch_gemv("fused_gemv", x, tabs, 6, 5, 2, 256 * 5, 0, spec,
                         0.5, True)
        with pytest.raises(ValueError, match="serves kernel 9"):
            ops.pcilt_fused_gemv_stacked(x, tabs[None], 0, spec, 0.5, 2)
    assert [_fused_args(c)[2] for c in fake_card.calls] == [2, 2]
    assert fake_card.calls[1][1][3] is not None  # the counters' buffer
    assert ops.GEMV_VARIANT_LAUNCHES == {"split": 0, "staged": 2,
                                         "direct": 0}


def test_a_library_that_plans_otherwise_is_refused(fake_card, monkeypatch):
    """The first staged launch of a shape asks the library for its plan;
    one that differs from the mirror raises before anything is launched,
    as do other constants."""
    def plan(B, G, V, O, es, out):
        p = ops.gemv_staged_plan(B, G, V, O, es)
        out[:] = [int(p.wide), p.rpt, p.rows, p.cols, p.rtiles, p.ctiles,
                  p.cluster * 2, ops.gemv_staged_slab(p, G, V),
                  ops.gemv_staged_smem_bytes(p, G, V),
                  ops.gemv_staged_planes(p)]
        return 0

    def config(cfg):
        cfg[:] = ops.STAGED_GEMV_CONFIG
        return 0

    fake_card.pcilt_gemv_staged_plan = plan
    fake_card.pcilt_gemv_staged_config = config
    x, tabs, spec = _gemv_call(64, 256, 1, 96)
    with ops._gemv_forced("staged"), \
            pytest.raises(RuntimeError, match="kernels.ops as"):
        ops.pcilt_fused_gemv(x, tabs, spec, 0.5, 1)
    assert fake_card.calls == []
    monkeypatch.setattr(ops, "_GEMV_STAGED_CHECKED", set())

    def other_config(cfg):
        cfg[:] = (512, 8, 2, 8, 2) + ops.STAGED_GEMV_CONFIG[5:]
        return 0

    fake_card.pcilt_gemv_staged_config = other_config
    with ops._gemv_forced("staged"), \
            pytest.raises(RuntimeError, match="staged constants"):
        ops.pcilt_fused_gemv(x, tabs, spec, 0.5, 1)
    assert fake_card.calls == []


def test_a_forced_staged_design_past_a_byte_is_refused(fake_card):
    """Offsets past a byte (V 4096 at 4 bits, group 3) cannot be staged: a
    forced staged launch raises, the split serves the shape."""
    x, tabs, spec = _gemv_call(32, 4, 3, 5)
    assert ops.gemv_candidates(32, 4, 5, 4, 4096) == ["split", "direct"]
    with ops._gemv_forced("staged"):
        with pytest.raises(ValueError, match="V <= 256"):
            ops.pcilt_fused_gemv(x, tabs, spec, 0.5, 3)
    assert fake_card.calls == []


@pytest.mark.parametrize("B", [4, 64])
def test_a_forced_staged_design_on_the_cpu_runs_the_plain_version(B):
    """On CPU tensors kernel 9 runs its plain version whatever is forced or
    chosen, and no design is counted."""
    rng = np.random.default_rng(B)
    spec = QuantSpec(4, True)
    w = torch.from_numpy(rng.normal(size=(24, 13)).astype(np.float32))
    tabs = build_grouped_tables(w, spec, 0.2, 1)
    x = torch.from_numpy(rng.normal(size=(B, 24)).astype(np.float32))
    seen = dict(ops.GEMV_VARIANT_LAUNCHES)
    want = ops.fused_gemv_plain(x, tabs, spec, 0.2, 1)
    with ops._gemv_forced("staged"):
        got = ops.pcilt_fused_gemv(x, tabs, spec, 0.2, 1)
    assert torch.equal(got, want)
    assert torch.equal(ops.pcilt_fused_gemv(x, tabs, spec, 0.2, 1), want)
    assert ops.GEMV_VARIANT_LAUNCHES == seen


@pytest.mark.parametrize("group,tiles", [(1, (64, 64, 96)),
                                         (2, (64, 32, 96))])
def test_many_rows_plain_version_matches_reference(group, tiles):
    """At the staged design's rows (B 64, G 256 segments, O 96; V 16 at
    group 1, V 256 at group 2) the port's kernel-9 wrapper (its plain
    version on the CPU) against the reference's Pallas kernel in interpret
    mode, on numpy inputs from a seed: |d| <= 1e-4 * (max|ref| + |ref|),
    kernel 9's tolerance (float32 sums of 256 rows in another order)."""
    rng = np.random.default_rng(64 + group)
    B, G, O = 64, 256, 96
    spec = QuantSpec(4, True)
    w = (rng.normal(size=(G * group, O)) * (G * group) ** -0.5) \
        .astype(np.float32)
    x = (2.0 * rng.normal(size=(B, G * group))).astype(np.float32)
    scale = np.float32(0.2)
    tabs = build_grouped_tables(torch.from_numpy(w), spec, float(scale),
                                group)
    assert tabs.shape == (G, 1 << (4 * group), O)
    got = ops.pcilt_fused_gemv(torch.from_numpy(x), tabs, spec, scale,
                               group).numpy()
    want = np.asarray(pcilt_fused_gemv_pallas(
        jnp.asarray(x), jnp.full((1, 1), scale, jnp.float32),
        jnp.asarray(tabs.numpy()), bits=spec.bits,
        zero_point=spec.zero_point, group=group, tiles=tiles,
        interpret=True))
    assert got.shape == want.shape == (B, O)
    bound = 1e-4 * (np.abs(want).max() + np.abs(want))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
