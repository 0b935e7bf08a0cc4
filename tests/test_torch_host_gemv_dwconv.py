"""The new designs of kernels 6, 7 and 2, host side, on the CPU.

Kernels 6 and 7 (the host-packed GEMV and conv, one CUDA body) take a
"split" design at decode-size M (kernel 9's split, at any ``V``) and a
"staged" design for ``V <= 256`` and many rows:
``kernels.ops.gemv_host_variant`` chooses, ``kernels.ops.gemv_host_block_tile``
mirrors the staged grid (every ``(row, column)`` owned by one block), and
the plain version that the card's kernels are held to matches the JAX
package's Pallas kernels (interpret mode), offsets out of range included,
at decode-size M too.
Kernel 2 (the fused dwconv) takes a "tiled" design whose counters need no
zeroed buffer: its plain version with counters matches the JAX fused
kernel at the decode window, saturating taps at both ends of the window
included, and the wrapper passes the design, a scratch for the counters
and no zero fill.  The wrappers count each design; a forced design that
cannot serve a shape raises.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``); ``kernels.ops`` checks at the library's
first launch that its tiling is this module's mirror of it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lut_layers as jl
from repro.core import quantization as jq
from repro.kernels.pcilt_conv2d import pcilt_conv2d_pallas
from repro.kernels.pcilt_dwconv1d import pcilt_fused_dwconv1d_pallas
from repro.kernels.pcilt_gemv import pcilt_gemv_pallas
from repro_torch.core import quantization as tq
from repro_torch.interop import to_torch
from repro_torch.kernels import build, ops

#: the paper CNN's layers (G, O) at group 1, V = 256, and the rows of the
#: images it is served at: 1024x768 (the fused, shared and host-packed
#: forwards) and 256x192 (the host-packed forward at full width)
CNN_LAYERS = [(25, 50), (1250, 80), (2000, 120), (3000, 200), (5000, 350)]
CNN_ROWS = [1024 * 768, 256 * 192]
#: (M, O) of the tiling checks: ragged rows and columns, one row tile, the
#: 256x192 image at conv4's width
TILE_SHAPES = [(1024, 32), (1025, 33), (3000, 350), (2047, 13), (5000, 50),
               (4096, 97), (1, 1), (1030, 80), (49152, 350)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("M", CNN_ROWS)
@pytest.mark.parametrize("G,O", CNN_LAYERS)
def test_paper_cnn_layers_take_the_staged_design(itemsize, M, G, O):
    """Every layer of the paper CNN, at every image the port serves it at,
    takes the staged design, whose ring fits a block's shared memory."""
    assert ops.gemv_host_variant(M, G, 256, O, itemsize) == "staged"
    assert ops.gemv_host_smem_bytes(itemsize) <= ops.SMEM_LIMIT == 232448


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("G,O", CNN_LAYERS)
def test_a_small_image_splits_its_narrow_layers(itemsize, G, O):
    """On a 64x48 image (the crop that phase 3 holds to the plain version)
    a layer's staged grid is 3 row tiles by a few column tiles, a fraction
    of one wave of blocks: each layer whose table rows a segment (3072 x O
    x itemsize bytes) stay within ``HOST_SPLIT_WAVE_BYTES`` takes the split
    design, conv4 in float32 (4.3 MB) the staged one."""
    M = 64 * 48
    n_r, n_c = ops.gemv_host_tiles(M, O)
    assert n_r * n_c <= ops.HOST_SMS
    want = "staged" if M * O * itemsize > ops.HOST_SPLIT_WAVE_BYTES \
        else "split"
    assert want == ("staged" if (O, itemsize) == (350, 4) else "split")
    assert ops.gemv_host_variant(M, G, 256, O, itemsize) == want


@pytest.mark.parametrize("M,G,V,O", [(4, 512, 256, 3072),   # phase 10's plan
                                     (4, 8, 16, 4),         # learnable
                                     (1023, 25, 256, 50)])  # under a tile
def test_small_m_takes_the_split_design(M, G, V, O):
    """M under one row tile (serve_pcilt's gate and the M = 4 GEMVs of
    plans and learnable tables) takes the split design, at V > 256 too."""
    for itemsize in (4, 2):
        assert ops.gemv_host_variant(M, G, V, O, itemsize) == "split"
        assert ops.gemv_host_variant(M, G, 1 << 16, O, itemsize) == "split"


@pytest.mark.parametrize("M,O,itemsize,want", [
    (256, 3072, 4, "split"), (384, 3072, 4, "staged"),
    (1023, 3072, 4, "staged"), (1024, 3072, 4, "staged"),
    (512, 3072, 2, "split"), (768, 3072, 2, "staged"),
    (1024, 80, 4, "split"), (4096, 80, 4, "split"),
    (4096, 4, 4, "split"), (65536, 4, 4, "staged"), (1 << 20, 4, 4, "staged"),
    (786432, 80, 4, "staged")])
def test_the_split_and_staged_designs_meet_at_the_measured_crossover(
        M, O, itemsize, want):
    """Where the staged design fits, the chooser takes the split while a
    segment's table rows (M rows of O x itemsize bytes, at least
    ``HOST_SPLIT_ROW_BYTES`` each) stay within ``HOST_SPLIT_WAVE_BYTES`` a
    wave of staged blocks (132 a wave): at the gate's widths up to 256
    float32 rows, the staged design from 384 (12.6 MB at 1023 rows); at
    conv1's narrow O the split up to 4096 rows; at O = 4 the split at 4096
    rows, the staged design at 65536; the paper CNN's conv1 at 1024x768
    staged."""
    assert ops.gemv_host_variant(M, 512, 256, O, itemsize) == want


@pytest.mark.parametrize("M,G,V,O", [(4096, 6, 512, 33),    # V > 256
                                     (2048, 2, 1 << 16, 7)])
def test_large_v_takes_the_direct_design(M, G, V, O):
    """At one row tile and more, V > 256 (an offset no longer fits a byte)
    keeps the direct design."""
    for itemsize in (4, 2):
        assert ops.gemv_host_variant(M, G, V, O, itemsize) == "direct"


@pytest.mark.parametrize("M,O", TILE_SHAPES)
def test_host_tiling_owns_every_row_and_column_once(M, O):
    """The staged grid's blocks own disjoint ``[m0, m1) x [o0, o1)`` tiles
    that cover the ``[M, O]`` output exactly once, within a row tile and a
    column tile each; consecutive blocks (the ones resident together)
    share a column tile."""
    n_r, n_c = ops.gemv_host_tiles(M, O)
    seen = np.zeros((M, O), np.int32)
    for i in range(n_r * n_c):
        (m0, m1), (o0, o1) = ops.gemv_host_block_tile(i, M, O)
        assert 0 <= m0 < m1 <= M and 0 <= o0 < o1 <= O
        assert m1 - m0 <= ops.HOST_ROW_TILE and o1 - o0 <= ops.HOST_COL_TILE
        assert m0 % ops.HOST_ROW_TILE == 0 and o0 % ops.HOST_COL_TILE == 0
        seen[m0:m1, o0:o1] += 1
        if i % n_r:
            assert ops.gemv_host_block_tile(i - 1, M, O)[1] == (o0, o1)
    assert (seen == 1).all()


def test_host_tiling_at_conv4():
    """conv4 on a 1024x768 image: 768 row tiles of 1024 pixels, 11 column
    tiles of 32 columns (the last 30 wide), 8448 blocks; a float32 block
    holds 2 x 64 KB of slices, 16 segments' offset bytes and masks and a
    32 KB chunk of raw offsets (8 segments of 1024 rows)."""
    assert ops.gemv_host_tiles(1024 * 768, 350) == (768, 11)
    assert ops.gemv_host_block_tile(8447, 1024 * 768, 350) == \
        ((767 * 1024, 768 * 1024), (320, 350))
    assert [ops.gemv_host_block_tile(i, 1024 * 768, 350)[0]
            for i in range(3)] == [(0, 1024), (1024, 2048), (2048, 3072)]
    rings = 16 * (1024 + 256 + 128 + 4) + 1024 * 8 * 4
    assert ops.gemv_host_smem_bytes(4) == 2 * 65536 + rings
    assert ops.gemv_host_smem_bytes(2) == 65536 + rings


def _host_offsets(rng, shape, V):
    """Offsets with -1, V and 2**31 - 1 mixed in."""
    off = rng.integers(0, V, size=shape).astype(np.int32)
    flat = off.reshape(-1)
    n = flat.size
    flat[rng.choice(n, size=max(3, n // 9), replace=False)] = \
        rng.choice(np.array([-1, V, 2 ** 31 - 1], np.int32), size=max(3, n // 9))
    return off


HOST_PLAIN = [  # M, G, V, O, table dtype, exact grid
    (20, 6, 16, 40, "float32", True),
    (20, 6, 16, 40, "float32", False),
    (7, 25, 256, 50, "float32", True),      # conv0's G and O
    (33, 5, 64, 13, "bfloat16", True),
    (16, 9, 256, 97, "bfloat16", False),
    # decode-size M, the split design's rows
    (1, 64, 256, 200, "float32", False),
    (1, 6, 4096, 9, "float32", True),
    (4, 8, 16, 4, "float32", False),        # the learnable example's tables
    (4, 25, 256, 13, "bfloat16", True),
    (4, 32, 256, 96, "bfloat16", False),
]


def _compare(got, want, dtype, exact):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,G,V,O,dtype,exact", HOST_PLAIN)
def test_gemv_host_plain_matches_pallas(M, G, V, O, dtype, exact):
    """Kernel 6's plain version (the CPU path and the card's oracle)
    against ``pcilt_gemv_pallas`` in interpret mode, with offsets of -1, V
    and 2**31 - 1 mixed in (they add nothing): bit-equal on an exact grid
    (integer cells), else within 1e-5 (float32: another summation order)
    or 1e-2 (bfloat16: one rounding of the float32 sum)."""
    rng = np.random.default_rng(M * 100 + G * 10 + V)
    tabs = (rng.integers(-3, 4, size=(G, V, O)) if exact
            else rng.normal(size=(G, V, O))).astype(np.float32)
    jtabs = jnp.asarray(tabs).astype(jnp.dtype(dtype))
    off = _host_offsets(rng, (M, G), V)
    want = pcilt_gemv_pallas(jnp.asarray(off), jtabs, interpret=True)
    got = ops.pcilt_gemv(torch.from_numpy(off), to_torch(jtabs))
    assert got.dtype == getattr(torch, dtype)
    _compare(got, want, dtype, exact)


@pytest.mark.parametrize("B,H,W,G,V,O,dtype,exact", [
    (1, 8, 6, 25, 256, 50, "float32", True),
    (2, 4, 5, 9, 16, 13, "float32", False),
    (1, 8, 3, 6, 64, 20, "bfloat16", True)])
def test_conv2d_host_plain_matches_pallas(B, H, W, G, V, O, dtype, exact):
    """Kernel 7's plain version (kernel 6's over the flattened pixels)
    against ``pcilt_conv2d_pallas`` in interpret mode, offsets out of range
    included; the tolerances of kernel 6's test."""
    rng = np.random.default_rng(B * H * W + G)
    tabs = (rng.integers(-3, 4, size=(G, V, O)) if exact
            else rng.normal(size=(G, V, O))).astype(np.float32)
    jtabs = jnp.asarray(tabs).astype(jnp.dtype(dtype))
    off = _host_offsets(rng, (B, H, W, G), V)
    want = pcilt_conv2d_pallas(jnp.asarray(off), jtabs, interpret=True)
    got = ops.pcilt_conv2d(torch.from_numpy(off), to_torch(jtabs))
    assert got.shape == (B, H, W, O)
    _compare(got, want, dtype, exact)
    flat = ops.gemv_host_plain(torch.from_numpy(off).reshape(-1, G),
                               to_torch(jtabs))
    assert torch.equal(flat.reshape(got.shape), got)


@pytest.mark.parametrize("C,bits,dtype", [(48, 4, "float32"),
                                          (130, 2, "float32"),
                                          (64, 2, "bfloat16")])
def test_dwconv_window_plain_matches_fused_pallas(C, bits, dtype):
    """Kernel 2's plain version with counters against the JAX fused kernel
    (``pcilt_fused_dwconv1d_pallas``, interpret mode, counters on) at the
    decode window ``[4, 4, C]`` (VALID, 4 taps), with saturating taps at
    both ends of the window: outputs, count and ratio exact."""
    rng = np.random.default_rng(C + bits)
    k, B = 4, 4
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    scale = np.float32(0.25)
    filt = rng.normal(size=(k, C)).astype(np.float32)
    tabs = jl.build_dwconv_tables(jnp.asarray(filt), sj, jnp.float32(scale))
    tabs = tabs.astype(jnp.dtype(dtype))
    x = (1.5 * rng.normal(size=(B, k, C))).astype(np.float32)
    x[:, 0, ::3] = 40.0     # the oldest tap, counted by j == 0
    x[:, -1, 1::3] = -40.0  # the newest, counted by the last output
    x[1, 1, 5] = 11.0
    want, wc, wr = pcilt_fused_dwconv1d_pallas(
        jnp.asarray(x), jnp.full((1, 1), scale, jnp.float32), tabs,
        bits=bits, zero_point=sj.zero_point, k=k, tiles=(1, C),
        counters=True, interpret=True)
    got, gc, gr = ops.pcilt_fused_dwconv1d(torch.from_numpy(x),
                                           to_torch(tabs), st, float(scale),
                                           k, "VALID", with_stats=True)
    assert got.shape == (B, 1, C) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    assert int(gc) == int(wc) >= 2 * 4 * (C // 3)  # both ends, every slot
    assert float(gr) == float(wr) == float(np.float32(40.0) / scale)


DW_GRID_CASES = [  # rows (B * To), C, 16-byte operands
    (4, 1792, True),        # the decode window: one cluster of 16
    (8192, 1792, True),     # the full signal: the ticket, 4 channels a lane
    (8192, 1792, False),
    (27, 33, False), (3, 64, True), (80, 8, True), (1, 5, True),
    (2, 4100, True), (5000, 2, False)]


@pytest.mark.parametrize("rows,C,wide", DW_GRID_CASES)
def test_dwconv_tiled_grid_covers_every_output_once(rows, C, wide):
    """The tiled grid's lanes (``nv`` adjacent channels each, 4 only when
    ``wide`` and C % 4 == 0) over its blocks (channel tile ``x``, rows
    ``y, y + ry, ...``) cover every ``(row, channel)`` once, no lane past
    C; a block has at most 512 threads, the grid at most ~1056 blocks."""
    g = ops.dwconv_tiled_grid(rows, C, wide and C % 4 == 0)
    assert g.nv in (1, 4) and (g.nv == 1 or C % 4 == 0)
    assert g.threads % 32 == 0 and g.threads <= ops.DW_TILED_THREADS
    assert g.tiles * g.ry <= max(ops.DW_TILED_TARGET_BLOCKS, g.tiles)
    seen = np.zeros((rows, C), np.int32)
    for x in range(g.tiles):
        for lane in range(g.threads):
            c = (x * g.threads + lane) * g.nv
            if c >= C:
                continue
            assert c + g.nv <= C
            for y in range(g.ry):
                seen[y::g.ry, c:c + g.nv] += 1
    assert (seen == 1).all()


def test_dwconv_tiled_grid_at_the_decode_window():
    """The decode window ([4, 4, 1792] VALID: 4 rows) takes a channel a
    lane over 4 tiles of 448 lanes, 16 blocks: one cluster sums its
    counters; the full signal ([4, 2048, 1792]) 4 channels a lane over 4
    tiles of 128 lanes and 264 row blocks, its counters through the
    ticket."""
    assert ops.dwconv_tiled_grid(4, 1792, True) == ops.DwTiledGrid(
        nv=1, tiles=4, threads=448, ry=4)
    assert 4 * 4 <= ops.DW_CLUSTER_BLOCKS
    g = ops.dwconv_tiled_grid(8192, 1792, True)
    assert g == ops.DwTiledGrid(nv=4, tiles=4, threads=128, ry=264)
    assert g.tiles * g.ry > ops.DW_CLUSTER_BLOCKS


class _FakeLibrary:
    """Stands in for the CUDA libraries: records each launch's arguments and
    answers the configuration queries from the mirrors (or from
    ``config``)."""

    def __init__(self):
        self.calls = []
        self.config = None
        self.split = None
        self.plans = []

    def pcilt_gemv_host_staged_config(self, cfg):
        cfg[:] = list(self.config or (
            ops.HOST_ROW_TILE, ops.HOST_COL_TILE, ops.HOST_STAGES,
            ops.HOST_CHUNK, ops.HOST_OFF_RING, ops.HOST_MAX_V))
        return 0

    def pcilt_gemv_split_config(self, cfg):
        cfg[:] = [ops.GEMV_ROWS, ops.GEMV_WARPS, ops.GEMV_SEG_BATCH,
                  ops.GEMV_TARGET_BLOCKS, ops.GEMV_MAX_CLUSTER,
                  ops.GEMV_MIN_SEGS, ops.GEMV_MAX_LANES,
                  ops.GEMV_LANE_BYTES]
        return 0

    def pcilt_gemv_split_plan(self, B, G, O, itemsize, out):
        sp = self.split or ops.gemv_variant(B, G, O, itemsize)
        self.plans.append((B, G, O, itemsize))
        out[:] = [*sp, ops.gemv_smem_bytes(sp, G), ops.gemv_slab(sp, G),
                  ops.gemv_planes(sp)]
        return 0

    def pcilt_dwconv1d_tiled_plan(self, rows, C, wide, out):
        out[:] = list(ops.dwconv_tiled_grid(rows, C, bool(wide)))
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
    test's own; the dwconv scratch is a CPU tensor."""
    lib = _FakeLibrary()
    scratch = torch.zeros(4, dtype=torch.int32)
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(ops, "_call", lambda name, fn, x, *args: fn(*args))
    monkeypatch.setattr(ops, "_dwconv_scratch", lambda lib_, dev: scratch)
    monkeypatch.setattr(ops, "_HOST_CHECKED", [])
    monkeypatch.setattr(ops, "_HOST_SPLIT_CHECKED", set())
    monkeypatch.setattr(ops, "_DW_TILED_CHECKED", set())
    monkeypatch.setattr(ops, "LAUNCHES", dict.fromkeys(ops.LAUNCHES, 0))
    monkeypatch.setattr(ops, "GEMV_HOST_VARIANT_LAUNCHES",
                        {"split": 0, "staged": 0, "direct": 0})
    monkeypatch.setattr(ops, "DWCONV_VARIANT_LAUNCHES",
                        {"tiled": 0, "direct": 0})
    lib.scratch = scratch
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_launch_passes_and_counts_the_design(fake_card, dtype):
    """``pcilt_gemv`` and ``pcilt_conv2d`` launch the staged design (code
    0) at 16 row tiles of 128 columns and V <= 256 (a segment's rows, 8 MB
    in float32 and 4 MB in bfloat16, past the split's share of a wave),
    the split one (2) at M = 4, the kept one (1) at V = 512 and M >= one
    row tile; ``variant="direct"`` forces the kept one; each counts one
    launch of its kernel and of the design."""
    dt = ops._TABLE_DTYPES[dtype]
    big = torch.zeros(16384, 5, dtype=torch.int32)  # 16 row tiles
    ops.pcilt_gemv(big, torch.zeros(5, 256, 128, dtype=dtype))
    ops.pcilt_gemv(big[:4], torch.zeros(5, 256, 128, dtype=dtype))
    ops.pcilt_gemv(big, torch.zeros(5, 512, 128, dtype=dtype))
    ops._gemv_host(big, torch.zeros(5, 256, 128, dtype=dtype),
                   variant="direct")
    ops.pcilt_conv2d(big.view(2, 64, 128, 5), torch.zeros(5, 16, 128,
                                                          dtype=dtype))
    assert [n for n, _ in fake_card.calls] == [f"pcilt_gemv_host_{dt}"] * 5
    assert [a[3:] for _, a in fake_card.calls] == [
        (16384, 5, 256, 128, 0), (4, 5, 256, 128, 2),
        (16384, 5, 512, 128, 1), (16384, 5, 256, 128, 1),
        (16384, 5, 16, 128, 0)]
    assert ops.LAUNCHES["gemv_host"] == 4 and ops.LAUNCHES["conv2d_host"] == 1
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {"split": 1, "staged": 2,
                                              "direct": 2}


def test_forced_host_designs_that_cannot_serve_a_shape_raise(fake_card):
    """The staged design at V = 512 and an unknown design raise before
    anything is launched; the staged design forced at M = 4 runs (it
    serves any M; the chooser keeps it for a full row tile)."""
    off = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be staged"):
        ops._gemv_host(off, torch.zeros(3, 512, 8), variant="staged")
    with pytest.raises(ValueError, match="unknown variant"):
        ops._conv2d_host(off.view(1, 2, 2, 3), torch.zeros(3, 16, 8),
                         variant="tiled")
    assert fake_card.calls == []
    ops._gemv_host(off, torch.zeros(3, 16, 8), variant="staged")
    assert fake_card.calls[0][1][-1] == 0


def test_a_library_that_tiles_otherwise_is_refused(fake_card):
    """The first staged launch asks the library for its tiling; one that
    differs from the mirror raises before anything is launched."""
    fake_card.config = (ops.HOST_ROW_TILE, ops.HOST_COL_TILE, ops.HOST_STAGES,
                        ops.HOST_CHUNK + 8, ops.HOST_OFF_RING, ops.HOST_MAX_V)
    with pytest.raises(RuntimeError, match="differs from kernels.ops"):
        ops.pcilt_gemv(torch.zeros(16384, 3, dtype=torch.int32),
                       torch.zeros(3, 256, 128))
    assert fake_card.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 64, 1023])
def test_host_split_launch_passes_and_counts_the_design(fake_card, dtype,
                                                         M):
    """Below one row tile ``pcilt_gemv`` launches the split design (code 2)
    at V 256 and 4096 alike, the library's split of each shape checked
    against ``gemv_variant`` (kernel 9's split of the same (M, G, O,
    itemsize)) at its first launch only; ``variant="split"`` forces it at
    2048 rows; the conv wrapper over M pixels splits too; each counts one
    launch of its kernel and of the design."""
    dt = ops._TABLE_DTYPES[dtype]
    es = torch.empty((), dtype=dtype).element_size()
    off = torch.zeros(M, 7, dtype=torch.int32)
    ops.pcilt_gemv(off, torch.zeros(7, 256, 13, dtype=dtype))
    ops.pcilt_gemv(off, torch.zeros(7, 4096, 13, dtype=dtype))
    ops._gemv_host(torch.zeros(2048, 7, dtype=torch.int32),
                   torch.zeros(7, 16, 13, dtype=dtype), variant="split")
    ops.pcilt_conv2d(off.view(1, 1, M, 7), torch.zeros(7, 16, 3, dtype=dtype))
    assert [n for n, _ in fake_card.calls] == [f"pcilt_gemv_host_{dt}"] * 4
    assert [a[3:] for _, a in fake_card.calls] == [
        (M, 7, 256, 13, 2), (M, 7, 4096, 13, 2), (2048, 7, 16, 13, 2),
        (M, 7, 16, 3, 2)]
    assert fake_card.plans == [(M, 7, 13, es), (2048, 7, 13, es),
                               (M, 7, 3, es)]
    assert ops._HOST_SPLIT_CHECKED == {"config"} | {
        (ops.gemv_variant(m, 7, o, es).chunks, 7, o, es)
        for m, o in ((M, 13), (2048, 13), (M, 3))}
    assert ops.LAUNCHES["gemv_host"] == 3 and ops.LAUNCHES["conv2d_host"] == 1
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {"split": 4, "staged": 0,
                                              "direct": 0}


def test_a_library_that_splits_kernel_6_otherwise_is_refused(fake_card):
    """The first split launch of a shape asks the library for its split;
    one that differs from ``gemv_variant`` raises before anything is
    launched."""
    fake_card.split = ops.gemv_variant(4, 7, 13, 4)._replace(cluster=2)
    with pytest.raises(RuntimeError, match="kernels.ops as"):
        ops.pcilt_gemv(torch.zeros(4, 7, dtype=torch.int32),
                       torch.zeros(7, 16, 13))
    assert fake_card.calls == []


def test_a_split_past_its_rows_is_neither_chosen_nor_launched(fake_card,
                                                              monkeypatch):
    """Past ``HOST_SPLIT_MAX_ROWS`` (its row chunks are int) the split is
    no candidate, and forcing it raises before anything is launched."""
    monkeypatch.setattr(ops, "HOST_SPLIT_MAX_ROWS", 8)
    assert ops.gemv_host_candidates(9, 7, 16, 13, 4) == ["staged", "direct"]
    assert ops.gemv_host_candidates(8, 7, 16, 13, 4)[0] == "split"
    with pytest.raises(ValueError, match="exceed the split's"):
        ops._gemv_host(torch.zeros(9, 7, dtype=torch.int32),
                       torch.zeros(7, 16, 13), variant="split")
    assert fake_card.calls == []


def test_dwconv_launch_passes_the_design_and_no_fill(fake_card,
                                                     monkeypatch):
    """The tiled design (code 0) gets the scratch for its counters and
    stats that no fill kernel zeroes (``torch.empty``); the kept design
    (code 1, forced by ``variant=`` or :func:`ops._dwconv_forced`) gets no
    scratch and zeroed stats; without counters neither gets stats.  Each
    counts one launch of kernel 2 and of its design."""
    spec = tq.QuantSpec(4, True)
    x, tabs = torch.zeros(4, 4, 8), torch.zeros(8, 1 << 16)
    fills = []
    zeros = torch.zeros

    def counted_zeros(*args, **kw):
        fills.append(args)
        return zeros(*args, **kw)

    monkeypatch.setattr(ops.torch, "zeros", counted_zeros)
    ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.5, 4, "VALID", with_stats=True)
    assert fills == []
    ops._fused_dwconv1d(x, tabs, spec, 0.5, 4, "VALID", with_stats=True,
                        variant="direct")
    assert fills == [(2,)]
    with ops._dwconv_forced("direct"):
        ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.5, 4, "VALID")
    ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.5, 4, "VALID")
    calls = [a for _, a in fake_card.calls]
    assert [a[-1] for a in calls] == [0, 1, 1, 0]     # the design
    assert [a[-2] for a in calls] == [1, 1, 0, 0]     # counters
    assert [a[4].value for a in calls] == [fake_card.scratch.data_ptr(),
                                           None, None,
                                           fake_card.scratch.data_ptr()]
    assert calls[2][3].value is None and calls[3][3].value is None
    assert calls[0][5:13] == (4, 4, 8, 1 << 16, 4, 4, spec.zero_point, 0.5)
    assert ops.LAUNCHES["dwconv1d"] == 4
    assert ops.DWCONV_VARIANT_LAUNCHES == {"tiled": 2, "direct": 2}
    with pytest.raises(ValueError, match="unknown variant"):
        ops._fused_dwconv1d(x, tabs, spec, 0.5, 4, "VALID", variant="staged")
    with pytest.raises(ValueError, match="unknown fused dwconv variant"):
        with ops._dwconv_forced("split"):
            pass


def test_dwconv_beyond_eight_taps_takes_the_direct_design(fake_card):
    """The tiled design keeps its taps in registers, up to 8: k = 9 (2-bit,
    V = 2**18) takes the kept design unforced, and forcing the tiled one
    raises before anything is launched."""
    spec = tq.QuantSpec(2, True)
    assert [ops.dwconv_variant(k) for k in (1, 4, 8, 9, 15)] == \
        ["tiled"] * 3 + ["direct"] * 2
    x, tabs = torch.zeros(2, 9, 4), torch.zeros(4, 1 << 18)
    ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.5, 9, "VALID")
    assert [a[-1] for _, a in fake_card.calls] == [1]
    with pytest.raises(ValueError, match="cannot be tiled"):
        ops._fused_dwconv1d(x, tabs, spec, 0.5, 9, "VALID", variant="tiled")
    assert len(fake_card.calls) == 1
    assert ops.DWCONV_VARIANT_LAUNCHES == {"tiled": 0, "direct": 1}


def test_forced_designs_on_the_cpu_run_the_plain_versions():
    """A design is forced on CUDA tensors only: on CPU tensors kernels 6
    and 2 run their plain versions whatever is forced, and no design is
    counted."""
    rng = np.random.default_rng(4)
    tabs = torch.from_numpy(rng.normal(size=(5, 16, 7)).astype(np.float32))
    off = torch.from_numpy(_host_offsets(rng, (9, 5), 16))
    spec = tq.QuantSpec(2, True)
    dtabs = torch.from_numpy(rng.normal(size=(6, 256)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 7, 6)).astype(np.float32))
    seen = (dict(ops.GEMV_HOST_VARIANT_LAUNCHES),
            dict(ops.DWCONV_VARIANT_LAUNCHES))
    want = ops.gemv_host_plain(off, tabs)
    for v in ("split", "staged", "direct"):
        assert torch.equal(ops._gemv_host(off, tabs, variant=v), want)
    wd = ops.pcilt_fused_dwconv1d(x, dtabs, spec, 0.4, 4, with_stats=True)
    for v in ("tiled", "direct"):
        got = ops._fused_dwconv1d(x, dtabs, spec, 0.4, 4, with_stats=True,
                                  variant=v)
        assert all(torch.equal(a, b) for a, b in zip(got, wd))
    assert (dict(ops.GEMV_HOST_VARIANT_LAUNCHES),
            dict(ops.DWCONV_VARIANT_LAUNCHES)) == seen
