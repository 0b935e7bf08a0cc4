"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
no CUDA device is present (decided when the test runs, never at import).
Run on a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none.  The plain
versions are held to the JAX reference on the CPU by
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.quantization import QuantSpec
from repro_torch.core.pcilt import build_grouped_tables
from repro_torch.core.lut_layers import build_dwconv_tables
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pcilt_dwconv1d_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _assert_sum_close(got, want, rtol):
    """A GEMV sums up to 768 float32 rows in another order than its plain
    version: |d| <= rtol * (max|want| + |want|).  bfloat16 (rtol 1e-2)
    rounds that float32 sum once."""
    got, want = got.float(), want.float()
    bound = rtol * (want.abs().max() + want.abs())
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,O", [(4, 384, 1536), (3, 5, 24), (1, 7, 130)])
def test_gemv_stacked_kernel_matches_plain(cuda, dtype, B, G, O):
    rng = np.random.default_rng(G + O)
    spec, group, L = QuantSpec(4, True), 2, 3
    w = torch.from_numpy(rng.normal(size=(L, G * group, O)).astype(np.float32))
    tabs = torch.stack([build_grouped_tables(w[l], spec, 0.2, group)
                        for l in range(L)]).to(dtype)
    x = torch.from_numpy((2 * rng.normal(size=(B, G * group))).astype(np.float32))
    want, wc, wr = ops.pcilt_fused_gemv_stacked(x, tabs, 1, spec, 0.2, group,
                                                with_stats=True)
    before = ops.LAUNCHES["gemv_stacked"]
    got, gc, gr = ops.pcilt_fused_gemv_stacked(x.to(cuda), tabs.to(cuda), 1,
                                               spec, 0.2, group,
                                               with_stats=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gemv_stacked"] == before + 1
    assert int(gc) == int(wc) and float(gr) == float(wr)
    _assert_sum_close(got.cpu(), want, 1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,O,group", [(262148, 64, 64, 2),
                                         (4, 230000, 64, 1)])
def test_fused_gemv_past_the_split_ceilings_matches_plain(cuda, B, G, O,
                                                          group):
    """Kernel 9 past the grid's rows (65,537 row chunks of 4: each block
    walks its chunks) and past a 16-block cluster (230,000 segments: each
    block stages its offsets in slabs), where the reference computes:
    two launches bit-identical, within its tolerance of its plain version
    on the card."""
    gen = torch.Generator(device=cuda).manual_seed(G)
    spec = QuantSpec(4, True)
    tabs = torch.randn(G, 1 << (spec.bits * group), O, generator=gen,
                       device=cuda) * G ** -0.5
    x = torch.randn(B, G * group, generator=gen, device=cuda) * 2.0
    sp = ops.gemv_variant(B, G, O, 4)
    assert sp.chunks > ops.MAX_GRID_ROWS \
        or ops.gemv_slab(sp, G) < -(-G // sp.cluster)
    before = ops.GEMV_VARIANT_LAUNCHES["split"]
    with ops._gemv_forced("split"):  # the chooser stages so many rows
        got = ops.pcilt_fused_gemv(x, tabs, spec, 0.2, group)
        again = ops.pcilt_fused_gemv(x, tabs, spec, 0.2, group)
    torch.cuda.synchronize()
    assert ops.GEMV_VARIANT_LAUNCHES["split"] == before + 2
    assert torch.equal(got, again)
    _assert_sum_close(got, ops.fused_gemv_plain(x, tabs, spec, 0.2, group),
                      1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,padding", [(4, 4, 1792, "VALID"),
                                           (3, 9, 33, "CAUSAL")])
def test_dwconv1d_kernel_matches_plain_exactly(cuda, dtype, B, T, C, padding):
    rng = np.random.default_rng(C)
    spec, k = QuantSpec(4, True), 4
    filt = torch.from_numpy(rng.normal(size=(k, C)).astype(np.float32))
    tabs = build_dwconv_tables(filt, spec, 0.3).to(dtype)
    x = torch.from_numpy((1.5 * rng.normal(size=(B, T, C))).astype(np.float32))
    want, wc, wr = ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.3, k, padding,
                                            with_stats=True)
    got, gc, gr = ops.pcilt_fused_dwconv1d(x.to(cuda), tabs.to(cuda), spec,
                                           0.3, k, padding, with_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert int(gc) == int(wc) and float(gr) == float(wr)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,X,O", [(4, 384, 16, 50288), (2, 6, 3, 7)])
def test_shared_gemv_kernel_matches_plain(cuda, B, G, X, O):
    rng = np.random.default_rng(X + O)
    spec, group = QuantSpec(4, True), 2
    pool = torch.from_numpy(rng.normal(size=(X, 256, O)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, X, size=G).astype(np.int32))
    x = torch.from_numpy((2 * rng.normal(size=(B, G * group))).astype(np.float32))
    want = ops.pcilt_shared_gemv(x, pool, idx, spec, 0.2, group)
    got = ops.pcilt_shared_gemv(x.to(cuda), pool.to(cuda), idx.to(cuda), spec,
                                0.2, group)
    torch.cuda.synchronize()
    _assert_sum_close(got.cpu(), want, 1e-4)


def _conv_case(rng, B, H, W, C, O, k, bits, sym, group, exact):
    from repro_torch.core.lut_layers import flatten_filters

    spec = QuantSpec(bits, sym)
    filt = (rng.integers(-3, 4, size=(k, k, C, O)) if exact
            else rng.normal(size=(k, k, C, O))).astype(np.float32)
    scale = 0.5 if exact else 0.3
    tabs = build_grouped_tables(flatten_filters(torch.from_numpy(filt), group),
                                spec, scale, group)
    x = torch.from_numpy(rng.uniform(-1, 2, size=(B, H, W, C))
                         .astype(np.float32))
    return spec, scale, tabs, x


CONV_CASES = [  # B, H, W, C, O, k, stride, bits, symmetric, group, exact
    (1, 64, 48, 50, 80, 5, 1, 8, False, 1, False),  # the paper's conv1
    (1, 64, 48, 1, 50, 5, 1, 8, False, 1, True),    # conv0, exact grid
    (2, 9, 11, 3, 13, 3, 2, 4, True, 2, False),     # ragged: n_pad 1
    # staged design's edges: P = 3034 (not a multiple of the 1024-pixel
    # tile), B = 2, conv4's ragged O = 350, group 2 at V = 16
    (2, 37, 41, 5, 350, 5, 1, 2, True, 2, False),
    (2, 33, 35, 7, 50, 5, 2, 8, False, 1, False),   # conv0's O 50, stride 2
    (1, 20, 24, 6, 40, 3, 1, 4, True, 2, False),    # group 2 at V = 256
    (1, 40, 40, 200, 350, 5, 1, 8, False, 1, True),  # conv4's C, O: exact
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,O,k,stride,bits,sym,group,exact",
                         CONV_CASES)
def test_conv2d_kernels_match_plain(cuda, dtype, B, H, W, C, O, k, stride,
                                    bits, sym, group, exact):
    """Fused and shared-pool conv kernels (one pool pointer out of range)
    against their plain versions: bit-equal on an exact grid, else f32
    within 1e-4 of the largest output (another summation order over up to
    1250 rows), bf16 within 1e-2 (one rounding of the f32 sum)."""
    rng = np.random.default_rng(C + O)
    spec, scale, tabs, x = _conv_case(rng, B, H, W, C, O, k, bits, sym,
                                      group, exact)
    tabs = tabs.to(dtype)
    rtol = 0.0 if exact and dtype == torch.float32 else \
        (1e-2 if dtype == torch.bfloat16 else 1e-4)
    want = ops.pcilt_fused_conv2d(x, tabs, spec, scale, group, k, k,
                                  stride=stride)
    got = ops.pcilt_fused_conv2d(x.to(cuda), tabs.to(cuda), spec, scale,
                                 group, k, k, stride=stride)
    torch.cuda.synchronize()
    _assert_sum_close(got.cpu(), want, rtol)
    idx = torch.arange(tabs.shape[0], dtype=torch.int32)
    idx[1] = tabs.shape[0] + 5
    want = ops.pcilt_shared_conv2d(x, tabs, idx, spec, scale, group, k, k,
                                   stride=stride)
    got = ops.pcilt_shared_conv2d(x.to(cuda), tabs.to(cuda), idx.to(cuda),
                                  spec, scale, group, k, k, stride=stride)
    torch.cuda.synchronize()
    _assert_sum_close(got.cpu(), want, rtol)


def _conv_pair(rng, dtype, cuda, C=200, O=350, bits=8, group=1):
    """A small conv4-width case on the card: x, fused tables, a pool of X < G
    rows with one pointer out of range."""
    spec, scale, tabs, x = _conv_case(rng, 1, 21, 19, C, O, 5, bits, False,
                                      group, False)
    tabs = tabs.to(dtype).to(cuda)
    G = tabs.shape[0]
    idx = torch.from_numpy(rng.integers(0, G // 2, size=G).astype(np.int32))
    idx[G // 3] = G + 7
    return spec, scale, tabs, x.to(cuda), tabs[:G // 2], idx.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_variants_agree_and_are_deterministic(cuda, dtype):
    """At V = 256 both designs run when forced: the staged kernel, twice,
    bit-identical run to run (no atomics, one summation order), and
    within the file's tolerance of the kept kernel; the variant counts say
    which kernel served each call, one launch count per call."""
    rng = np.random.default_rng(13)
    spec, scale, tabs, x, pool, idx = _conv_pair(rng, dtype, cuda)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, call in (
            ("fused_conv2d", lambda v: ops._fused_conv2d(
                x, tabs, spec, scale, 1, 5, 5, variant=v)),
            ("shared_conv2d", lambda v: ops._shared_conv2d(
                x, pool, idx, spec, scale, 1, 5, 5, variant=v))):
        before = dict(ops.LAUNCHES)
        seen = dict(ops.CONV_VARIANT_LAUNCHES)
        first, again, default = call("staged"), call("staged"), call(None)
        kept = call("direct")
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before[name] + 4
        assert ops.CONV_VARIANT_LAUNCHES == {
            "staged": seen["staged"] + 3, "direct": seen["direct"] + 1}
        assert torch.equal(first, again) and torch.equal(first, default)
        _assert_sum_close(first.cpu(), kept.cpu(), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_v_conv2d_takes_the_kept_kernel(cuda, dtype):
    """8 bits x group 2 (V = 65536): offsets do not fit a byte, so the
    wrapper launches the kept kernel (counted as "direct"), forcing it
    gives the same bits, forcing the staged kernel raises, and the result
    matches the plain version."""
    rng = np.random.default_rng(17)
    spec, scale, tabs, x = _conv_case(rng, 2, 6, 7, 3, 13, 3, 8, False, 2,
                                      False)
    tabs = tabs.to(dtype)
    assert tabs.shape[1] == 65536
    want = ops.pcilt_fused_conv2d(x, tabs, spec, scale, 2, 3, 3)
    xd, td = x.to(cuda), tabs.to(cuda)
    seen = dict(ops.CONV_VARIANT_LAUNCHES)
    got = ops.pcilt_fused_conv2d(xd, td, spec, scale, 2, 3, 3)
    forced = ops._fused_conv2d(xd, td, spec, scale, 2, 3, 3,
                               variant="direct")
    torch.cuda.synchronize()
    assert ops.CONV_VARIANT_LAUNCHES == {"staged": seen["staged"],
                                         "direct": seen["direct"] + 2}
    assert torch.equal(got, forced)
    _assert_sum_close(got.cpu(), want,
                      1e-2 if dtype == torch.bfloat16 else 1e-4)
    with pytest.raises(ValueError, match="cannot be staged"):
        ops._fused_conv2d(xd, td, spec, scale, 2, 3, 3, variant="staged")


#: a segment shard of a mesh: (C, k, group, bits, D): the shards of G
#: segments over D devices, the last one holding the alignment slots where
#: kh*kw*C is not a multiple of the group
SHARD_CASES = [(200, 5, 1, 8, 4),   # conv4's C: each shard spans taps
               (64, 3, 1, 4, 16),   # 36 positions a shard: inside a tap
               (7, 3, 2, 2, 2),     # 63 positions + 1 alignment slot
               (5, 3, 3, 2, 5)]     # group 3 at V = 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,k,group,bits,D", SHARD_CASES)
def test_conv2d_kernels_match_plain_at_seg_offset(cuda, dtype, C, k, group,
                                                  bits, D):
    """Kernels 4 and 5 on each shard of a mesh (``seg_offset`` = d * G/D,
    ``n_total`` the padded patch), both designs: each against its plain
    version on the shard; the staged pre-pass of the shard's channels
    against its plain version; the shards' partials summed in order equal
    to the unsharded kernel within the file's tolerance."""
    rng = np.random.default_rng(C * k + D)
    spec, scale, tabs, x = _conv_case(rng, 2, 23, 19, C, 24, k, bits, True,
                                      group, False)
    tabs = tabs.to(dtype)
    G = tabs.shape[0]
    Gl, n_total = G // D, G * group
    assert G % D == 0
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    pool = tabs[:3]
    idx = torch.from_numpy(rng.integers(0, 3, size=G).astype(np.int32))
    xd = x.to(cuda)
    parts = []
    for d in range(D):
        kw = dict(seg_offset=d * Gl, n_total=n_total)
        t_d, i_d = tabs[d * Gl:(d + 1) * Gl], idx[d * Gl:(d + 1) * Gl]
        want = ops.pcilt_fused_conv2d(x, t_d, spec, scale, group, k, k, **kw)
        wsh = ops.pcilt_shared_conv2d(x, pool, i_d, spec, scale, group, k, k,
                                      **kw)
        for v in ("staged", "direct"):
            got = ops._fused_conv2d(xd, t_d.to(cuda), spec, scale, group, k,
                                    k, variant=v, **kw)
            gsh = ops._shared_conv2d(xd, pool.to(cuda), i_d.to(cuda), spec,
                                     scale, group, k, k, variant=v, **kw)
            torch.cuda.synchronize()
            _assert_sum_close(got.cpu(), want, rtol)
            _assert_sum_close(gsh.cpu(), wsh, rtol)
        parts.append(got.float())
        xp = ops.pad_nhwc(x, ops._conv_pads(x, k, k, 1, "SAME"))
        c0, Cs = ops.conv_code_channels(C, k, k, group, d * Gl, Gl)
        codes = ops._conv_codes(xp.to(cuda), spec, scale, c0, Cs)
        torch.cuda.synchronize()
        assert torch.equal(codes.cpu(),
                           ops.conv_codes_plain(xp, spec, scale, c0, Cs))
    whole = ops.pcilt_fused_conv2d(xd, tabs.to(cuda), spec, scale, group, k,
                                   k)
    torch.cuda.synchronize()
    _assert_sum_close(sum(parts[1:], parts[0]).cpu(), whole.cpu().float(),
                      rtol)


@pytest.mark.cuda
def test_conv2d_code_prepass_matches_plain(cuda):
    """The staged design's pre-pass: codes ``[B, C, Hp, Wp]`` of the padded
    image equal to its plain version (the quantizer bit for bit)."""
    rng = np.random.default_rng(19)
    x = (3 * rng.normal(size=(2, 13, 70, 37))).astype(np.float32)
    ties = (rng.integers(-64, 64, size=x.size // 7) + 0.5) * 0.25
    x.reshape(-1)[:7 * ties.size:7] = ties  # exact .5 code steps
    xp = torch.from_numpy(x)
    for spec in (QuantSpec(8, False), QuantSpec(4, True)):
        want = ops.conv_codes_plain(xp, spec, 0.25)
        got = ops._conv_codes(xp.to(cuda), spec, 0.25)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_packed_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(11)
    G, V, O = 300, 256, 97
    tabs = torch.from_numpy(rng.normal(size=(G, V, O)).astype(np.float32)) \
        .to(dtype)
    off = torch.from_numpy(rng.integers(0, V, size=(2, 7, 5, G))
                           .astype(np.int32))
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    before = dict(ops.LAUNCHES)
    got = ops.pcilt_conv2d(off.to(cuda), tabs.to(cuda))
    flat = ops.pcilt_gemv(off.reshape(-1, G).to(cuda), tabs.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["conv2d_host"] == before["conv2d_host"] + 1
    assert ops.LAUNCHES["gemv_host"] == before["gemv_host"] + 1
    want = ops.pcilt_conv2d(off, tabs)
    _assert_sum_close(got.cpu(), want, rtol)
    _assert_sum_close(flat.cpu().reshape(want.shape), want, rtol)


PAIRED_CASES = [  # B, G2, group, bits, O, exact grid
    (4, 192, 2, 2, 1536, False),   # wz of the paired decode
    (4, 384, 2, 2, 768, False),    # wo
    (3, 5, 2, 2, 13, False),       # ragged
    (4, 16, 2, 2, 130, True),      # exact grid
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G2,group,bits,O,exact", PAIRED_CASES)
def test_paired_gemv_kernels_match_plain(cuda, dtype, B, G2, group, bits, O,
                                         exact):
    """The paired stacked GEMV (segment-major [G2, L, V2, O], the layer by
    offset) and the unstacked paired GEMV against their plain versions,
    with and without counters: bit-equal on an exact grid in float32, else
    within 1e-4 of the largest output (float32) or 1e-2 (bfloat16, one
    rounding of the float32 sum); counters exact."""
    from repro_torch.core.pcilt import (build_paired_stacked_tables,
                                        build_paired_tables)

    rng = np.random.default_rng(G2 + O)
    spec, L, n = QuantSpec(bits, True), 3, G2 * 2 * group
    ws = torch.from_numpy((rng.integers(-3, 4, size=(L, n, O)) if exact
                           else rng.normal(size=(L, n, O)) * n ** -0.5)
                          .astype(np.float32))
    scale = 0.5 if exact else 0.2
    stack = build_paired_stacked_tables(ws, spec, [scale] * L, group,
                                        dtype=dtype)
    tabs = build_paired_tables(ws[2], spec, scale, group).to(dtype)
    x = torch.from_numpy((2 * rng.normal(size=(B, n))).astype(np.float32))
    rtol = 0.0 if exact and dtype == torch.float32 else \
        (1e-2 if dtype == torch.bfloat16 else 1e-4)
    for stats in (False, True):
        before = dict(ops.LAUNCHES)
        runs = [(ops.pcilt_fused_gemv_paired_stacked, "gemv_paired_stacked",
                 (stack, 2)),
                (ops.pcilt_fused_gemv_paired, "gemv_paired", (tabs,))]
        for fn, name, tab_args in runs:
            want = fn(x, *tab_args, spec, scale, group, with_stats=stats)
            dev_args = tuple(a.to(cuda) if torch.is_tensor(a) else a
                             for a in tab_args)
            got = fn(x.to(cuda), *dev_args, spec, scale, group,
                     with_stats=stats)
            torch.cuda.synchronize()
            assert ops.LAUNCHES[name] == before[name] + 1
            if stats:
                (got, gc, gr), (want, wc, wr) = got, want
                assert int(gc) == int(wc) and float(gr) == float(wr)
            _assert_sum_close(got.cpu(), want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,O", [(4, 512, 3072), (3, 7, 13)])
def test_fused_gemv_kernel_matches_plain(cuda, dtype, B, G, O):
    rng = np.random.default_rng(G + O)
    spec, group = QuantSpec(4, True), 2
    w = torch.from_numpy(rng.normal(size=(G * group, O)).astype(np.float32))
    tabs = build_grouped_tables(w, spec, 0.2, group).to(dtype)
    x = torch.from_numpy((2 * rng.normal(size=(B, G * group))).astype(np.float32))
    want = ops.pcilt_fused_gemv(x, tabs, spec, 0.2, group)
    before = ops.LAUNCHES["fused_gemv"]
    got = ops.pcilt_fused_gemv(x.to(cuda), tabs.to(cuda), spec, 0.2, group)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_gemv"] == before + 1
    _assert_sum_close(got.cpu(), want, 1e-2 if dtype == torch.bfloat16 else 1e-4)


GEMV_STAGED_CASES = [  # B, G, group, O, table dtype
    (64, 256, 1, 96, torch.float32),    # the wide layout, a cluster
    (64, 128, 2, 96, torch.float32),    # the narrow layout (V 256)
    (40, 96, 1, 13, torch.bfloat16),    # ragged O, element-wise copies
    (768, 64, 2, 200, torch.float32),   # a 1024-row tile, ragged columns
    (300, 40, 1, 520, torch.float32),   # three row tiles, three columns
    (32, 700, 1, 64, torch.bfloat16),   # 16-block cluster, bfloat16
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,group,O,dtype", GEMV_STAGED_CASES)
def test_fused_gemv_staged_matches_plain_twice(cuda, B, G, group, O, dtype):
    """Kernel 9's staged design, forced: two launches bit-identical (a
    fixed summation order, no float atomics), within kernel 9's tolerance
    of its plain version, the library's plan checked against the mirror;
    with counters (its counter launch) the counts equal the split's and the
    plain version's exactly."""
    rng = np.random.default_rng(B + G + O)
    spec = QuantSpec(4, True)
    V = 1 << (spec.bits * group)
    w = rng.normal(size=(G * group, O)) * (G * group) ** -0.5
    tabs = build_grouped_tables(torch.from_numpy(w.astype(np.float32)),
                                spec, 0.2, group).to(dtype)
    x = torch.from_numpy((2 * rng.normal(size=(B, G * group)))
                         .astype(np.float32))
    want = ops.pcilt_fused_gemv(x, tabs, spec, 0.2, group)
    xc, tc = x.to(cuda), tabs.to(cuda)
    seen = dict(ops.GEMV_VARIANT_LAUNCHES)
    with ops._gemv_forced("staged"):
        got = ops.pcilt_fused_gemv(xc, tc, spec, 0.2, group)
        again = ops.pcilt_fused_gemv(xc, tc, spec, 0.2, group)
    torch.cuda.synchronize()
    assert ops.GEMV_VARIANT_LAUNCHES["staged"] == seen["staged"] + 2
    assert torch.equal(got, again)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    _assert_sum_close(got.cpu(), want, rtol)
    runs = {}
    for design in ("staged", "split"):
        runs[design] = ops._launch_gemv(
            "fused_gemv", xc, tc, G, O, group, V * O, 0, spec, 0.2, True,
            variant=design)
    torch.cuda.synchronize()
    _, wc, wr = ops.gemv_stacked_plain(x, tabs[None], 0, spec, 0.2, group,
                                       with_stats=True)
    for out, cnt, ratio in runs.values():
        assert int(cnt) == int(wc) and float(ratio) == float(wr)
    assert torch.equal(runs["staged"][0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,V", [(4, 2048, 1792, 256), (3, 5, 33, 16)])
def test_dwconv1d_host_kernel_matches_plain_exactly(cuda, dtype, B, T, C, V):
    """One fetch per output: exact; an offset outside [0, V) gives 0."""
    rng = np.random.default_rng(C + V)
    tabs = torch.from_numpy(rng.normal(size=(C, V)).astype(np.float32)) \
        .to(dtype)
    off = torch.from_numpy(rng.integers(0, V, size=(B, T, C)).astype(np.int32))
    off[0, 0, 0], off[-1, -1, -1] = -3, V + 2
    want = ops.pcilt_dwconv1d(off, tabs)
    before = ops.LAUNCHES["dwconv1d_host"]
    got = ops.pcilt_dwconv1d(off.to(cuda), tabs.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dwconv1d_host"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert float(got[0, 0, 0]) == 0.0


def _plan_case(rng, n, G, O, exact, skips=3):
    """A generalized plan over ``x [*, n]``: ``G`` segments of 2 drawn from
    the positions (some reused, some left out), ``skips`` slots -1."""
    from repro_torch.core.offsets import SegmentPlan

    idx = rng.integers(0, n, size=(G, 2)).astype(np.int32)
    idx.reshape(-1)[rng.choice(2 * G, size=skips, replace=False)] = -1
    plan = SegmentPlan(idx)
    w = torch.from_numpy((rng.integers(-3, 4, size=(n, O)) if exact
                          else rng.normal(size=(n, O))).astype(np.float32))
    return plan, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,G,O", [(4, 1024, 512, 3072), (3, 21, 7, 13),
                                     (1, 300, 175, 130)])
def test_plan_gemv_kernel_matches_plain(cuda, dtype, B, n, G, O):
    """Kernel 11 against its plain version: -1 slots, reused positions,
    n != G*group, odd G, a ragged O edge; float32 within 1e-4 of the
    largest output, bfloat16 within 1e-2."""
    rng = np.random.default_rng(n + O)
    spec = QuantSpec(4, True)
    plan, w = _plan_case(rng, n, G, O, False)
    tabs = build_grouped_tables(w, spec, 0.2, 2, plan=plan).to(dtype)
    x = torch.from_numpy((2 * rng.normal(size=(B, n))).astype(np.float32))
    want = ops.pcilt_fused_gemv_plan(x, tabs, plan.on("cpu"), spec, 0.2, 2)
    before = ops.LAUNCHES["gemv_plan"]
    got = ops.pcilt_fused_gemv_plan(x.to(cuda), tabs.to(cuda), plan.on(cuda),
                                    spec, 0.2, 2)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gemv_plan"] == before + 1
    _assert_sum_close(got.cpu(), want, 1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_plan_gemv_exact_grid_is_bit_equal(cuda):
    """Integer weights, scale 0.5, codes on the grid: kernel 11, the
    host-packed route over ``plan.pack`` and the dense oracle agree bit for
    bit (every product and sum is exact)."""
    from repro_torch.core.lut_layers import pcilt_linear
    from repro_torch.core.quantization import dequantize, quantize

    rng = np.random.default_rng(5)
    spec = QuantSpec(2, True)
    plan, w = _plan_case(rng, 64, 33, 128, True)
    x = torch.from_numpy((rng.integers(-2, 2, size=(4, 64)) * 0.5)
                         .astype(np.float32)).to(cuda)
    tabs = build_grouped_tables(w.to(cuda), spec, 0.5, 2, plan=plan)
    fused = pcilt_linear(x, tabs, spec, 0.5, 2, plan=plan, path="fused")
    host = pcilt_linear(x, tabs, spec, 0.5, 2, plan=plan, path="kernel")
    codes = quantize(x, spec, 0.5)
    oracle = torch.einsum("bgj,gjo->bo",
                          dequantize(plan.gather_codes(codes), spec, 0.5),
                          plan.gather_weights(w.to(cuda)))
    torch.cuda.synchronize()
    assert torch.equal(fused, host) and torch.equal(fused, oracle)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_gemv_on_a_permutation_is_kernel9_on_permuted_x(cuda, dtype):
    """A plan that permutes the positions reads what the unstacked fused
    GEMV reads from ``x[:, perm]``: the two kernels agree bit for bit."""
    from repro_torch.core.offsets import SegmentPlan

    rng = np.random.default_rng(6)
    spec, n, O = QuantSpec(4, True), 256, 384
    perm = rng.permutation(n).astype(np.int32)
    plan = SegmentPlan(perm.reshape(-1, 2))
    w = torch.from_numpy(rng.normal(size=(n, O)).astype(np.float32))
    tabs = build_grouped_tables(w, spec, 0.2, 2, plan=plan).to(dtype).to(cuda)
    x = torch.from_numpy((2 * rng.normal(size=(4, n))).astype(np.float32)) \
        .to(cuda)
    got = ops.pcilt_fused_gemv_plan(x, tabs, plan.on(cuda), spec, 0.2, 2)
    want = ops.pcilt_fused_gemv(x[:, torch.from_numpy(perm).long().to(cuda)]
                                .contiguous(), tabs, spec, 0.2, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: kernels 1 and 8-11: the five launches of the fused GEMV source
GEMV_KINDS = ["gemv_stacked", "fused_gemv", "gemv_paired",
              "gemv_paired_stacked", "gemv_plan"]
GEMV_SPLIT_CASES = [  # B, G, O, exact grid
    (5, 96, 200, False),   # two row chunks (one ragged), O tiles, a cluster
    (4, 192, 24, False),   # wdt's O: several slots a warp, a cluster in f32
    (4, 160, 130, True),   # exact grid, a cluster of 8 in f32, ragged O
]


def _gemv_case(kind, dtype, B, G, O, exact, rng):
    """``(call(device, stats), counters)`` of one fused GEMV launch over
    seeded tables of ``G`` segments (pairs for the paired launches) and
    ``O`` columns: 4-bit group 2 (V 256) unpaired, 2-bit group 2 (V 256)
    paired; integer weights and scale 0.5 on an exact grid."""
    from repro_torch.core.pcilt import (build_paired_stacked_tables,
                                        build_paired_tables)

    group, L = 2, 3
    paired = kind in ("gemv_paired", "gemv_paired_stacked")
    spec = QuantSpec(2 if paired else 4, True)
    n = G * (2 * group if paired else group)
    scale = 0.5 if exact else 0.2

    def weights(*shape):
        w = (rng.integers(-3, 4, size=shape) if exact
             else rng.normal(size=shape) * shape[-2] ** -0.5)
        return torch.from_numpy(w.astype(np.float32))

    x = torch.from_numpy((2 * rng.normal(size=(B, n))).astype(np.float32))
    if kind == "gemv_stacked":
        ws = weights(L, n, O)
        tabs = torch.stack([build_grouped_tables(ws[l], spec, scale, group)
                            for l in range(L)]).to(dtype)
        return (lambda dev, stats: ops.pcilt_fused_gemv_stacked(
            x.to(dev), tabs.to(dev), 1, spec, scale, group,
            with_stats=stats)), True
    if kind == "fused_gemv":
        tabs = build_grouped_tables(weights(n, O), spec, scale,
                                    group).to(dtype)
        return (lambda dev, stats: ops.pcilt_fused_gemv(
            x.to(dev), tabs.to(dev), spec, scale, group)), False
    if kind == "gemv_paired":
        tabs = build_paired_tables(weights(n, O), spec, scale,
                                   group).to(dtype)
        return (lambda dev, stats: ops.pcilt_fused_gemv_paired(
            x.to(dev), tabs.to(dev), spec, scale, group,
            with_stats=stats)), True
    if kind == "gemv_paired_stacked":
        stack = build_paired_stacked_tables(weights(L, n, O), spec,
                                            [scale] * L, group, dtype=dtype)
        return (lambda dev, stats: ops.pcilt_fused_gemv_paired_stacked(
            x.to(dev), stack.to(dev), 2, spec, scale, group,
            with_stats=stats)), True
    plan, w = _plan_case(rng, n + 3, G, O, exact)
    tabs = build_grouped_tables(w, spec, scale, group, plan=plan).to(dtype)
    xp = torch.from_numpy((2 * rng.normal(size=(B, n + 3))).astype(np.float32))
    return (lambda dev, stats: ops.pcilt_fused_gemv_plan(
        xp.to(dev), tabs.to(dev), plan.on(dev), spec, scale, group)), False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", GEMV_KINDS)
@pytest.mark.parametrize("B,G,O,exact", GEMV_SPLIT_CASES)
def test_fused_gemv_designs_agree_and_are_deterministic(cuda, kind, dtype, B,
                                                        G, O, exact):
    """Each of the five fused GEMV launches in both designs: the split
    design (the default), twice, bit-identical (a fixed summation order, no
    float atomics), and the kept design forced, both against the plain
    version: bit-equal on an exact grid, else float32 within 1e-4 of the
    largest output, bfloat16 within 1e-2 (one rounding of the float32 sum);
    counters exact; the variant counts say which design served each call."""
    rng = np.random.default_rng(G + O + GEMV_KINDS.index(kind))
    call, counters = _gemv_case(kind, dtype, B, G, O, exact, rng)
    rtol = 0.0 if exact else (1e-2 if dtype == torch.bfloat16 else 1e-4)
    for stats in ((False, True) if counters else (False,)):
        want = call("cpu", stats)
        before = ops.LAUNCHES[kind]
        seen = dict(ops.GEMV_VARIANT_LAUNCHES)
        first, again = call(cuda, stats), call(cuda, stats)
        with ops._gemv_forced("direct"):
            kept = call(cuda, stats)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kind] == before + 3
        assert ops.GEMV_VARIANT_LAUNCHES == {
            "split": seen["split"] + 2, "staged": seen["staged"],
            "direct": seen["direct"] + 1}
        if stats:
            (first, fc, fr), (again, ac, ar) = first, again
            (kept, kc, kr), (want, wc, wr) = kept, want
            assert int(fc) == int(ac) == int(kc) == int(wc)
            assert float(fr) == float(ar) == float(kr) == float(wr)
        assert torch.equal(first, again)
        _assert_sum_close(first.cpu(), want, rtol)
        _assert_sum_close(kept.cpu(), want, rtol)
        _assert_sum_close(first.cpu(), kept.cpu(), rtol)


SHARED_SPLIT_CASES = [  # B, G, X, O, pool dtype, exact grid
    (4, 384, 384, 50288, torch.float32, False),   # the Mamba head
    (1, 384, 384, 50288, torch.float32, False),   # the head at B = 1
    (4, 384, 384, 50288, torch.bfloat16, False),
    (4, 64, 64, 130, torch.float32, True),        # exact grid, ragged O
    (5, 96, 40, 200, torch.float32, False),       # two row chunks
    (2, 6, 3, 7, torch.float32, False),           # 4-byte loads, no cluster
    (3, 5, 2, 13, torch.bfloat16, False),         # 2-byte loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,X,O,dtype,exact", SHARED_SPLIT_CASES)
def test_shared_gemv_designs_agree_and_are_deterministic(cuda, B, G, X, O,
                                                         dtype, exact):
    """Kernel 3 in both designs, with two pool pointers out of range: the
    split design (the default), twice, bit-identical and bit-equal to the
    plain version summed in the split's order (the same float32 adds); the
    kept design forced against the plain version (bit-equal on an exact
    grid, else float32 within 1e-4 of the largest output, bfloat16 within
    1e-2); the variant counts say which design served each call."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + O)
    spec, group = QuantSpec(4, True), 2
    if exact:
        pool = torch.randint(-3, 4, (X, 256, O), generator=gen, device=cuda)
        x = torch.randint(-8, 8, (B, G * group), generator=gen,
                          device=cuda) * 0.5
        scale = 0.5
    else:
        pool = torch.empty((X, 256, O), device=cuda)
        for p in range(X):
            pool[p].normal_(0.0, 0.05, generator=gen)
        x = torch.randn(B, G * group, generator=gen, device=cuda) * 2.0
        scale = 0.2
    pool = pool.to(dtype)
    idx = torch.randint(0, X, (G,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[0], idx[-1] = -1, X + 2
    seen = dict(ops.SHARED_GEMV_VARIANT_LAUNCHES)
    before = ops.LAUNCHES["shared_gemv"]
    first = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    again = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
    kept = ops._shared_gemv(x, pool, idx, spec, scale, group,
                            variant="direct")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["shared_gemv"] == before + 3
    assert ops.SHARED_GEMV_VARIANT_LAUNCHES == {
        "split": seen["split"] + 2, "direct": seen["direct"] + 1}
    assert torch.equal(first, again)
    assert torch.equal(first, ops.shared_gemv_plain(
        x, pool, idx, spec, scale, group, split_order=True))
    want = ops.shared_gemv_plain(x, pool, idx, spec, scale, group)
    rtol = 0.0 if exact else (1e-2 if dtype == torch.bfloat16 else 1e-4)
    _assert_sum_close(first, want, rtol)
    _assert_sum_close(kept, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,V,shift", [(4, 2048, 1792, 256, 0),
                                           (3, 5, 33, 16, 0),
                                           (2, 9, 64, 4, 1),
                                           (1, 300, 100, 64, 0)])
def test_dwconv1d_host_designs_agree_exactly(cuda, dtype, B, T, C, V, shift):
    """Kernel 12 in both designs, offsets out of range included: the staged
    design (the default; 4 channels a lane, or 1 where C or the offsets'
    address — ``shift`` elements past an aligned start — do not allow 16
    bytes), twice, and the kept design forced, all equal to the plain
    version (one fetch per output: exact); the variant counts say which
    design served each call."""
    gen = torch.Generator(device=cuda).manual_seed(C + V + shift)
    tabs = torch.randn(C, V, generator=gen, device=cuda).to(dtype)
    store = torch.randint(-2, V + 3, (B * T * C + shift,), generator=gen,
                          device=cuda, dtype=torch.int32)
    off = store[shift:].view(B, T, C)
    seen = dict(ops.DWCONV_HOST_VARIANT_LAUNCHES)
    first = ops.pcilt_dwconv1d(off, tabs)
    again = ops.pcilt_dwconv1d(off, tabs)
    kept = ops._dwconv1d_host(off, tabs, variant="direct")
    torch.cuda.synchronize()
    assert ops.DWCONV_HOST_VARIANT_LAUNCHES == {
        "staged": seen["staged"] + 2, "direct": seen["direct"] + 1}
    want = pcilt_dwconv1d_ref(off, tabs)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert torch.equal(kept, want)
    bad = (off < 0) | (off >= V)
    assert bool(bad.any()) and float(first[bad].abs().max()) == 0.0


@pytest.mark.cuda
def test_large_v_dwconv1d_host_takes_the_kept_kernel(cuda):
    """V = 65536 (4 bits x 4 taps) cannot be staged: the default runs the
    kept design, and forcing the staged one raises."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    tabs = torch.randn(8, 1 << 16, generator=gen, device=cuda)
    off = torch.randint(0, 1 << 16, (2, 5, 8), generator=gen, device=cuda,
                        dtype=torch.int32)
    seen = dict(ops.DWCONV_HOST_VARIANT_LAUNCHES)
    got = ops.pcilt_dwconv1d(off, tabs)
    torch.cuda.synchronize()
    assert ops.DWCONV_HOST_VARIANT_LAUNCHES == {
        "staged": seen["staged"], "direct": seen["direct"] + 1}
    assert torch.equal(got, pcilt_dwconv1d_ref(off, tabs))
    with pytest.raises(ValueError, match="cannot be staged"):
        ops._dwconv1d_host(off, tabs, variant="staged")


def _host_case(gen, dev, M, G, V, O, dtype, exact, shift=0):
    """Tables ``[G, V, O]`` (small integers on an exact grid) and offsets
    ``[M, G]`` (``shift`` int32 past an aligned start) with -1, V and
    2**31 - 1 mixed in."""
    if exact:
        tabs = torch.randint(-3, 4, (G, V, O), generator=gen, device=dev)
    else:
        tabs = torch.randn(G, V, O, generator=gen, device=dev)
    store = torch.randint(0, V, (M * G + shift,), generator=gen, device=dev,
                          dtype=torch.int32)
    off = store[shift:].view(M, G)
    bad = torch.randint(0, M * G, (3 * max(1, M * G // 97),),
                        generator=gen, device=dev)
    off.view(-1)[bad[0::3]] = -1
    off.view(-1)[bad[1::3]] = V
    off.view(-1)[bad[2::3]] = 2 ** 31 - 1
    return tabs.to(torch.float32).to(dtype), off


HOST_CASES = [  # M, G, V, O, exact grid, shift
    (1500, 300, 256, 97, False, 0),   # 16-byte offset vectors, ragged O
    (1500, 300, 256, 97, True, 0),
    (2100, 25, 256, 50, True, 0),     # conv0's G: 4-byte vectors
    (1030, 1250, 256, 80, False, 0),  # conv1's G: 8-byte vectors
    (1024, 7, 16, 13, True, 0),       # odd G, V < 256, O < 32
    (3000, 64, 64, 45, True, 1),      # an unaligned offsets array
    (1100, 40, 256, 350, True, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,G,V,O,exact,shift", HOST_CASES)
def test_gemv_host_staged_matches_plain_and_kept(cuda, dtype, M, G, V, O,
                                                 exact, shift):
    """Kernel 6's staged design (forced: the chooser splits some of these
    few row tiles) twice, bit-identical, and the kept design forced,
    against the plain version:
    bit-equal on an exact grid (integer cells: every float32 sum exact, one
    cast), else within 1e-4 (float32: another summation order over up to
    1250 rows) or 1e-2 (bfloat16: one rounding of the float32 sum); offsets
    of -1, V and 2**31 - 1 add nothing.  The variant counts say which
    design ran."""
    gen = torch.Generator(device=cuda).manual_seed(M + G + V + O + shift)
    tabs, off = _host_case(gen, cuda, M, G, V, O, dtype, exact, shift)
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    first = ops._gemv_host(off, tabs, variant="staged")
    again = ops._gemv_host(off, tabs, variant="staged")
    kept = ops._gemv_host(off, tabs, variant="direct")
    torch.cuda.synchronize()
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {
        "split": seen["split"], "staged": seen["staged"] + 2,
        "direct": seen["direct"] + 1}
    assert torch.equal(first, again)
    want = ops.gemv_host_plain(off, tabs)
    rtol = 0.0 if exact else (1e-2 if dtype == torch.bfloat16 else 1e-4)
    if exact:
        assert torch.equal(first, want) and torch.equal(kept, want)
    _assert_sum_close(first, want, rtol)
    _assert_sum_close(kept, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_host_staged_matches_plain(cuda, dtype):
    """Kernel 7 is kernel 6 over the flattened pixels: the staged design
    (forced) and the chooser's (split: 2640 rows of 120 columns are a
    fraction of one wave of staged blocks) on ``[2, 33, 40, G]`` offsets
    bit-equal to the plain version on an exact grid, and to kernel 6 on
    the same rows."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    G, V, O = 75, 256, 120
    tabs, off = _host_case(gen, cuda, 2 * 33 * 40, G, V, O, dtype, True)
    off4 = off.view(2, 33, 40, G)
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    got = ops._conv2d_host(off4, tabs, variant="staged")
    chosen = ops.pcilt_conv2d(off4, tabs)
    torch.cuda.synchronize()
    assert ops.GEMV_HOST_VARIANT_LAUNCHES["staged"] == seen["staged"] + 1
    assert ops.GEMV_HOST_VARIANT_LAUNCHES["split"] == seen["split"] + 1
    assert got.shape == (2, 33, 40, O)
    assert torch.equal(got, ops.gemv_host_plain(off, tabs).view(got.shape))
    assert torch.equal(chosen, got)
    assert torch.equal(got.view(-1, O), ops.pcilt_gemv(off, tabs))


@pytest.mark.cuda
def test_gemv_host_staged_never_reads_a_row_no_offset_names(cuda):
    """Every offset of segment 3 out of range and its table all NaN (as are
    the rows of segment 5 that no offset names): the staged, the split and
    the kept design give the finite sum of the other segments."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    M, G, V, O = 2048, 12, 256, 64
    tabs, off = _host_case(gen, cuda, M, G, V, O, torch.float32, True)
    off[:, 3] = torch.tensor([-1, V, 2 ** 31 - 1], dtype=torch.int32,
                             device=cuda).repeat(M // 3 + 1)[:M]
    tabs[3] = float("nan")
    off[:, 5] = off[:, 5] % 128
    tabs[5, 128:] = float("nan")
    want = ops.gemv_host_plain(off, tabs)
    assert bool(torch.isfinite(want).all())
    for variant in ("staged", "split", "direct"):
        got = ops._gemv_host(off, tabs, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want), variant


@pytest.mark.cuda
def test_gemv_host_small_m_takes_the_split_and_large_v_the_kept_kernel(
        cuda):
    """M under a row tile takes the split design unforced, at V = 512 too;
    V = 512 at 1040 rows cannot be staged and takes the kept design;
    forcing the staged design at V = 512 raises, at M = 4 it runs (and
    agrees), as does the split forced at 1040 rows."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    tabs, off = _host_case(gen, cuda, 40, 6, 512, 33, torch.float32, True)
    big_t, big_o = _host_case(gen, cuda, 1040, 6, 512, 33, torch.float32,
                              True)
    small_t, small_o = _host_case(gen, cuda, 4, 512, 256, 300, torch.float32,
                                  True)
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    got = ops.pcilt_gemv(off, tabs)
    big = ops.pcilt_gemv(big_o, big_t)
    small = ops.pcilt_gemv(small_o, small_t)
    forced = ops._gemv_host(small_o, small_t, variant="staged")
    split_big = ops._gemv_host(big_o, big_t, variant="split")
    torch.cuda.synchronize()
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {
        "split": seen["split"] + 3, "staged": seen["staged"] + 1,
        "direct": seen["direct"] + 1}
    assert torch.equal(got, ops.gemv_host_plain(off, tabs))
    assert torch.equal(big, ops.gemv_host_plain(big_o, big_t))
    assert torch.equal(small, ops.gemv_host_plain(small_o, small_t))
    assert torch.equal(forced, small) and torch.equal(split_big, big)
    with pytest.raises(ValueError, match="cannot be staged"):
        ops._gemv_host(off, tabs, variant="staged")


#: kernel 6's split at decode-size M: (M, G, V, O, exact grid, shift) —
#: serve_pcilt's gate, learnable's tables, a ragged O, V 4096 and 65536,
#: an unaligned offsets array, a slab (G past a 16-block cluster's shared
#: memory) and 1023 rows (the last row count the chooser splits)
HOST_SPLIT_CASES = [
    (1, 512, 256, 3072, False, 0), (4, 512, 256, 3072, False, 0),
    (4, 512, 256, 3072, True, 0), (64, 8, 16, 4, True, 0),
    (4, 8, 16, 4, False, 0), (3, 25, 256, 13, True, 1),
    (4, 64, 4096, 33, True, 0), (2, 6, 65536, 7, True, 2),
    (4, 230000, 2, 8, True, 0), (1023, 300, 256, 97, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,G,V,O,exact,shift", HOST_SPLIT_CASES)
def test_gemv_host_split_matches_plain_and_kept(cuda, dtype, M, G, V, O,
                                                exact, shift):
    """Kernel 6's split design (the wrappers' choice at these row counts)
    twice, bit-identical, and the kept design forced, against the plain
    version at kernel 9's tolerances: bit-equal on an exact grid, else
    within 1e-4 (float32, slices summed in another order) or 1e-2
    (bfloat16, one rounding of the float32 sum); offsets of -1, V and
    2**31 - 1 add nothing.  The library's split of the shape is checked
    against the mirror at the first launch."""
    gen = torch.Generator(device=cuda).manual_seed(M + G + V + O + shift)
    tabs, off = _host_case(gen, cuda, M, G, V, O, dtype, exact, shift)
    es = tabs.element_size()
    assert ops.gemv_host_variant(M, G, V, O, es) == "split"
    seen = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    first = ops.pcilt_gemv(off, tabs)
    again = ops.pcilt_gemv(off, tabs)
    kept = ops._gemv_host(off, tabs, variant="direct")
    torch.cuda.synchronize()
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {
        "split": seen["split"] + 2, "staged": seen["staged"],
        "direct": seen["direct"] + 1}
    assert (ops.gemv_variant(M, G, O, es).chunks, G, O, es) in \
        ops._HOST_SPLIT_CHECKED
    assert torch.equal(first, again)
    want = ops.gemv_host_plain(off, tabs)
    rtol = 0.0 if exact else (1e-2 if dtype == torch.bfloat16 else 1e-4)
    if exact:
        assert torch.equal(first, want) and torch.equal(kept, want)
    _assert_sum_close(first, want, rtol)
    _assert_sum_close(kept, want, rtol)


DWCONV_TILED_CASES = [  # B, T, C, k, bits, padding
    (4, 4, 1792, 4, 4, "VALID"),     # the decode window
    (4, 2048, 1792, 4, 2, "CAUSAL"),  # the full-sequence signal
    (3, 9, 33, 4, 4, "CAUSAL"),      # C % 4 != 0: a channel a lane
    (2, 6, 12, 3, 4, "SAME"),
    (2, 9, 8, 6, 2, "VALID"),        # k > 4
    (3, 4, 64, 4, 4, "VALID"),       # a cluster of 3 blocks
    (2, 40, 8, 4, 2, "CAUSAL"),      # 80 blocks: the ticket
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,k,bits,padding", DWCONV_TILED_CASES)
def test_dwconv1d_designs_agree_exactly(cuda, dtype, B, T, C, k, bits,
                                        padding):
    """Kernel 2's tiled design (the default) twice and the kept design
    forced, outputs and counters, against the plain version: exact (one
    fetch per output; an int count and a max).  Saturating taps at both
    ends of every window; the variant counts say which design ran."""
    from repro_torch.core.quantization import QuantSpec as QS

    gen = torch.Generator(device=cuda).manual_seed(B * T * C + k)
    spec = QS(bits, True)
    filt = torch.randn(k, C, generator=gen, device=cuda)
    tabs = build_dwconv_tables(filt, spec, 0.3).to(dtype)
    x = torch.randn(B, T, C, generator=gen, device=cuda) * 1.5
    x[:, 0, ::3] = 40.0
    x[:, -1, 1::3] = -40.0
    seen = dict(ops.DWCONV_VARIANT_LAUNCHES)
    runs = [ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.3, k, padding,
                                     with_stats=True) for _ in range(2)]
    runs.append(ops._fused_dwconv1d(x, tabs, spec, 0.3, k, padding,
                                    with_stats=True, variant="direct"))
    lo, hi = ops._dwconv_pads(k, padding)
    xp = torch.nn.functional.pad(x, (0, 0, lo, hi))
    want, wc, wr = ops.dwconv1d_plain(xp, tabs, spec, 0.3, k, with_stats=True)
    torch.cuda.synchronize()
    assert ops.DWCONV_VARIANT_LAUNCHES == {
        "tiled": seen["tiled"] + 2, "direct": seen["direct"] + 1}
    assert int(wc) > 0
    for got, gc, gr in runs:
        assert torch.equal(got, want)
        assert int(gc) == int(wc) and float(gr) == float(wr)


@pytest.mark.cuda
def test_dwconv1d_tiled_stats_do_not_accumulate(cuda):
    """Back-to-back tiled launches into output and stats memory pre-filled
    with garbage, on two signals: each call's stats are its own signal's
    (the scratch it sums in is left zeroed by every launch), through the
    wrapper and through the library entry point with the buffers given."""
    from repro_torch.core.quantization import QuantSpec as QS
    from repro_torch.kernels import build

    gen = torch.Generator(device=cuda).manual_seed(17)
    spec, k, C = QS(4, True), 4, 1792
    tabs = build_dwconv_tables(torch.randn(k, C, generator=gen, device=cuda),
                               spec, 0.3)
    xs = [torch.randn(4, 4, C, generator=gen, device=cuda) * s
          for s in (3.0, 0.5, 3.0)]
    wants = [ops.dwconv1d_plain(x, tabs, spec, 0.3, k, with_stats=True)
             for x in xs]
    for _ in range(2):
        junk = torch.full((4 * C + 64,), -123456, dtype=torch.int32,
                          device=cuda)
        del junk
        for x, (w, wc, wr) in zip(xs, wants):
            got, gc, gr = ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.3, k,
                                                   "VALID", with_stats=True)
            torch.cuda.synchronize()
            assert torch.equal(got, w)
            assert int(gc) == int(wc) and float(gr) == float(wr)
    lib = build.library("dwconv1d")
    scratch = ops._dwconv_scratch(lib, cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for x, (w, wc, wr) in zip(xs, wants):
        out = torch.full((4, 1, C), float("nan"), device=cuda)
        stats = torch.tensor([-5, 0x7f7f7f7f], dtype=torch.int32, device=cuda)
        err = lib.pcilt_dwconv1d_f32(
            x.data_ptr(), tabs.data_ptr(), out.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), 4, 4, C, tabs.shape[1], k, 4,
            spec.zero_point, 0.3, 1, 0, stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(out, w)
        assert int(stats[0]) == int(wc)
        assert float(stats[1:].view(torch.float32)[0]) == float(wr)
    assert int(scratch.abs().sum()) == 0


# ----------------------------------------------------------------------------
# The CRC-32 kernel, the in-place corruption and the monitored engine
# ----------------------------------------------------------------------------

CRC_LENGTHS = [1, 2, 15, 17, 2047, 2048, 2049, 65535, 65536, 65537,
               3 * 65536 + 11, 5_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("n", CRC_LENGTHS)
def test_crc32_kernel_equals_zlib_on_ragged_lengths(cuda, n):
    import zlib

    b = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    t = torch.from_numpy(b).to(cuda)
    before = ops.LAUNCHES["crc32"]
    got = ops.pcilt_crc32([t])
    again = ops.pcilt_crc32([t])
    assert got == again == [zlib.crc32(b.tobytes())]
    assert ops.LAUNCHES["crc32"] == before + 2
    from repro_torch.core.pcilt import table_checksum

    assert table_checksum(t[1:], crc=77) == zlib.crc32(b[1:].tobytes(), 77)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["banked", "kept"])
@pytest.mark.parametrize("n", [511, 512, 513, 3 * 512 + 1, 2049, 65537,
                               5_000_003])
def test_crc32_designs_equal_zlib(cuda, variant, n):
    """Each chunk-pass design, forced, at ragged lengths around 512 B,
    the lane slice and the chunk, from an aligned and two unaligned
    starts (the banked design's ragged chunks; ``chip_smoke.py`` phase 3
    holds its staged ones): bit-equal to zlib, counted as the design that
    ran."""
    import zlib

    b = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    t = torch.from_numpy(b).to(cuda)
    seen = dict(ops.CRC_VARIANT_LAUNCHES)
    with ops._crc_forced(variant):
        got = [ops.pcilt_crc32([t[o:]])[0] for o in (0, 1, 5)]
    assert got == [zlib.crc32(b[o:].tobytes()) for o in (0, 1, 5)]
    assert ops.CRC_VARIANT_LAUNCHES[variant] == seen[variant] + 3


@pytest.mark.cuda
def test_crc32_kernel_over_ranges_bf16_and_strided_layers(cuda):
    """Several streams in one launch (ragged lengths at unaligned
    addresses, an empty one, ragged ranges of one tensor), a bfloat16
    table (its 16-bit words) and a layer of a segment-major stack (G2
    ranges); the library's device launches are counted."""
    import zlib

    rng = np.random.default_rng(1)
    host = rng.integers(0, 256, 300_001, dtype=np.uint8)
    base = torch.from_numpy(host).to(cuda)
    cuts = [(3, 5), (8, 65536), (65544, 1), (65545, 0), (65545, 200_000)]
    starts = [3, 70_001, 9, 140_000]
    before = dict(ops.LAUNCHES), dict(ops.CRC_DEVICE_LAUNCHES)
    got = ops.pcilt_crc32([base[a:a + n] for a, n in cuts]
                          + [(base, starts, 65_537)])
    assert got == [zlib.crc32(host[a:a + n].tobytes()) for a, n in cuts] + [
        zlib.crc32(b"".join(host[a:a + 65_537].tobytes() for a in starts))]
    assert ops.LAUNCHES["crc32"] == before[0]["crc32"] + 1
    assert ops.CRC_DEVICE_LAUNCHES["passes"] == \
        before[1]["passes"] + 2  # the chunk pass and one combine pass
    t = torch.randn(7, 129, 33, device=cuda).to(torch.bfloat16)
    host = t.cpu().view(torch.int16).numpy()
    assert ops.pcilt_crc32([t]) == [zlib.crc32(host.tobytes())]
    from repro_torch.core.pcilt import layer_checksum, stacked_checksums

    stack = torch.randn(192, 3, 16, 40, device=cuda)
    host = stack.cpu().numpy()
    for l in range(3):
        assert layer_checksum(stack, l, axis=1) == zlib.crc32(
            np.ascontiguousarray(host[:, l]).tobytes())
    assert stacked_checksums(stack, axis=1) == stacked_checksums(
        stack.cpu(), axis=1)


@pytest.mark.cuda
def test_table_checksum_of_a_cuda_tensor_stays_on_the_card(cuda, monkeypatch):
    """Neither ``zlib`` nor a host copy of the table: patch both to raise."""
    import zlib

    from repro_torch.core import pcilt

    t = torch.randn(3, 64, 1000, device=cuda)
    want = zlib.crc32(t.cpu().numpy().tobytes())

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor's checksum reached zlib")

    monkeypatch.setattr(pcilt.zlib, "crc32", refuse)
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        if self.numel() > 16:
            raise AssertionError("a CUDA table was copied to the host")
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    assert pcilt.table_checksum(t) == want
    assert pcilt.stacked_checksums(t) == [
        pcilt.table_checksum(t[l]) for l in range(3)]


@pytest.mark.cuda
def test_corrupt_table_flips_in_place_on_the_card(cuda):
    from repro_torch.runtime import FaultInjector

    for dtype in (torch.float32, torch.bfloat16):
        t = torch.randn(4, 8, 16, 32, device=cuda).to(dtype)
        before = t.clone()
        ptr = t.data_ptr()
        inj = FaultInjector(seed=3)
        got = inj.corrupt_table(t, n_flips=5)
        assert got is t and t.data_ptr() == ptr and t.is_cuda
        changed = (t != before).nonzero().tolist()
        assert sorted(map(tuple, changed)) == sorted(inj.events[0]["sites"])


def _to(bundle, dev):
    """A Mamba PCILT bundle with its tables on ``dev`` (scales stay host
    float32, the record ints)."""
    out = dict(bundle, tables=bundle["tables"].to(dev))
    out["proj"] = dict(bundle["proj"], tables={
        k: v.to(dev) for k, v in bundle["proj"]["tables"].items()},
        scales={k: v.clone() for k, v in bundle["proj"]["scales"].items()})
    out["head"] = dict(bundle["head"], **{
        k: bundle["head"][k].to(dev) for k in ("pool", "seg_idx",
                                                "kernel_q")})
    out["integrity"] = {"conv": list(bundle["integrity"]["conv"]),
                        "proj": {k: list(v) for k, v in
                                 bundle["integrity"]["proj"].items()},
                        "head": dict(bundle["integrity"]["head"])}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["chaos", "drift"])
def test_monitored_engine_on_the_card_equals_the_cpu_run(cuda, plan):
    """The smoke-config engine under its health monitor, on the same
    weights and tables on the CPU and on the card, through the ``--chaos``
    or ``--chaos-drift`` plan: the same outcomes, health events, restarts,
    rollbacks and tokens (logits within 1e-4 each step; a greedy token may
    differ only at a tie of the coarse-grid head, where the CPU run's is
    fed on), and the CRC kernel launched by the monitor."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.interop import tree_map
    from repro_torch.launch import serve
    from repro_torch.runtime import FaultInjector

    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    donor = serve.Engine(cfg, slots=2, pcilt=True, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = serve.Engine(
            cfg, slots=2, pcilt=True, device=dev,
            params=tree_map(lambda t: t.to(dev), donor.params),
            pcilt_bundle=_to(donor.pdecode.pcilt, dev))
        inj = FaultInjector(fail_at=(7,), seed=1)
        eng.chaos = (serve._chaos_plan(eng, inj) if plan == "chaos"
                     else serve._chaos_drift_plan(eng, inj))
        runs[dev] = (eng, inj, serve.make_requests(cfg, 3, 6, 1))
    log = []
    ceng = runs["cpu"][0]
    craw = ceng._raw_step

    def logged():
        fed = ceng.tokens.copy()
        logits, cache = craw()
        log.append((fed, logits.clone()))
        return logits, cache

    ceng._raw_step = logged
    cstats = ceng.run(runs["cpu"][2])
    geng = runs["cuda"][0]
    graw = geng._raw_step
    n = {"i": 0}

    def compared():
        fed, want = log[n["i"]]
        n["i"] += 1
        assert np.array_equal(geng.tokens, fed)
        logits, cache = graw()
        if not all(bool(torch.isfinite(t).all())
                   for t in cache["layers"].values()):
            return logits, cache  # the poisoned step: refused by both
        got = logits.cpu()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        for b in (got.argmax(-1) != want.argmax(-1)).nonzero()[:, 0]:
            assert got[b, want[b].argmax()] >= got[b].max() - 1e-4
        return want.to(cuda), cache

    geng._raw_step = compared
    before = ops.LAUNCHES["crc32"]
    gstats = geng.run(runs["cuda"][2])
    assert ops.LAUNCHES["crc32"] > before
    assert n["i"] == len(log)
    ev = lambda s: [(e["kind"], e["layer"], e["tick"])  # noqa: E731
                    for e in s["health_events"]]
    assert ev(gstats) == ev(cstats) and ev(gstats)
    for key in ("outcomes", "restarts", "rollbacks", "decode_ticks",
                "prefill_ticks"):
        assert gstats[key] == cstats[key], key
    assert runs["cuda"][1].events == runs["cpu"][1].events
    assert [r.out for r in runs["cuda"][2]] == [r.out for r in runs["cpu"][2]]


@pytest.mark.cuda
def test_dense_engine_on_the_card_equals_the_cpu_run(cuda):
    """qwen3-0.6b's smoke config (float32 compute, the bfloat16 KV cache)
    served by the dense ``Engine`` on the same weights on the CPU and on
    the card: the same outcomes and tokens, the logits within 1e-4 of the
    largest each step (a greedy token may differ only at a near-tie, where
    the CPU run's is fed on), and no PCILT kernel launched."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import tree_map
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              dtype=torch.float32)
    donor = serve.Engine(cfg, slots=4, device="cpu")
    runs = {dev: serve.Engine(cfg, slots=4, device=dev,
                              params=tree_map(lambda t: t.to(dev),
                                              donor.params))
            for dev in ("cpu", "cuda")}
    log = []
    ceng = runs["cpu"]
    craw = ceng._raw_step

    def logged():
        fed = ceng.tokens.copy()
        logits, cache = craw()
        log.append((fed, logits.clone()))
        return logits, cache

    ceng._raw_step = logged
    creqs = serve.make_requests(cfg, 6, 8, 0)
    cstats = ceng.run(creqs)
    geng = runs["cuda"]
    graw = geng._raw_step
    n = {"i": 0}

    def compared():
        fed, want = log[n["i"]]
        n["i"] += 1
        assert np.array_equal(geng.tokens, fed)
        logits, cache = graw()
        got = logits.cpu()
        tol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
        for b in (got.argmax(-1) != want.argmax(-1)).nonzero()[:, 0]:
            assert got[b, want[b].argmax()] >= got[b].max() - tol
        return want.to(cuda), cache

    geng._raw_step = compared
    before = dict(ops.LAUNCHES)
    greqs = serve.make_requests(cfg, 6, 8, 0)
    gstats = geng.run(greqs)
    assert dict(ops.LAUNCHES) == before
    assert n["i"] == len(log)
    for key in ("outcomes", "restarts", "decode_ticks", "prefill_ticks"):
        assert gstats[key] == cstats[key], key
    assert [r.out for r in greqs] == [r.out for r in creqs]
    assert geng.cache["pos"] == ceng.cache["pos"]


@pytest.mark.cuda
def test_prefill_matches_a_decode_replay_on_the_card(cuda):
    """``make_prefill_step`` on a 40-token prompt at qwen3-0.6b's smoke
    config (bfloat16 compute) against a decode replay of the prompt into a
    64-slot cache on the card: the last logits within 2e-2 of the
    largest, argmax equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, device=cuda)
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 40))).to(cuda)
    with torch.no_grad():
        want, pcache = make_prefill_step(cfg)(params, {"tokens": prompt})
        cache = dict(materialize(model.cache_specs(2, 64), 0, device=cuda), pos=0)
        step = make_decode_step(cfg)
        for t in range(prompt.shape[1]):
            got, cache = step(params, cache, prompt[:, t:t + 1])
    assert pcache["pos"] == cache["pos"] == 40
    got, want = got.float(), want.float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_serve_pcilt_kernel_path_on_the_card(cuda):
    """``launch.serve_pcilt.run`` on the card: its checks pass (the kernel
    path among them, one launch of kernel 6's split design at M = 4)."""
    from repro_torch.launch import serve_pcilt

    ops.reset_launches()
    res = serve_pcilt.run(device="cuda", log=lambda m: None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gemv_host"] == 1
    assert ops.GEMV_HOST_VARIANT_LAUNCHES == {"split": 1, "staged": 0,
                                              "direct": 0}
    assert max(res["errors"].values()) <= serve_pcilt.TOL


@pytest.mark.cuda
def test_decode_pcilt_on_the_card_equals_the_cpu_run(cuda):
    """``launch.decode_pcilt.run`` through kernels 1 and 2 on the card: its
    oracle check passes and its tokens equal the CPU run's."""
    from repro_torch.launch import decode_pcilt

    ops.reset_launches()
    res = decode_pcilt.run(device="cuda", log=lambda m: None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gemv_stacked"] > 0 and ops.LAUNCHES["dwconv1d"] > 0
    assert res["tokens"] == decode_pcilt.run(device="cpu",
                                             log=lambda m: None)["tokens"]


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One ``make_train_step`` of the smoke config on the card and on the
    CPU (bfloat16 compute): the loss and the gradients' global norm within
    2e-2, each leaf within 5e-2 of its largest gradient.  The gradients
    are read off a probe optimizer (``b1 = 0``, no clipping), whose first
    moment after one update is the gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_smoke_config(arch)
    probe = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)
    nb = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=4,
                     seed=5).batch(0)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = materialize(build_model(cfg).param_specs(), 0, device=dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        _, st, m = make_train_step(cfg, None, probe)(p, adamw_init(p, probe),
                                                     b)
        runs[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                          {k: v.cpu() for k, v in _flat_tree(st["m"]).items()})
    (lg, ng, gg), (lc, nc, gc) = runs["cuda"], runs["cpu"]
    assert abs(lg - lc) <= 2e-2 * abs(lc)
    assert abs(ng - nc) <= 2e-2 * abs(nc)
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= \
            5e-2 * float(gc[k].abs().max()), k


@pytest.mark.cuda
def test_mamba_block_pcilt_on_the_card_equals_plain(cuda):
    """The full-sequence PCILT conv on the card: ``_conv1d(pcilt=)`` through
    kernel 2 (CAUSAL) equals its plain version on the same signal and
    tables, output and counters exactly; ``mamba_block(pcilt=)`` launches
    it once, and raises for a bfloat16 signal (the kernel takes float32)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.interop import tree_map
    from repro_torch.nn import ssm
    from repro_torch.nn.module import materialize

    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    params = materialize(ssm.mamba_spec(cfg), 3, device="cpu")
    pc = ssm.build_pcilt_conv(params, cfg, 0.05)
    C = pc["tables"].shape[0]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.2, (3, 37, C)).astype(np.float32))
    want, _, wc, wr = ssm._conv1d(params, cfg, x, pcilt=pc, with_stats=True)
    on = tree_map(lambda t: t.to(cuda), params)
    pcc = dict(pc, tables=pc["tables"].to(cuda))
    ops.reset_launches()
    got, _, gc, gr = ssm._conv1d(on, cfg, x.to(cuda), pcilt=pcc,
                                 with_stats=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dwconv1d"] == 1
    assert torch.equal(got.cpu(), want)
    assert int(gc) == int(wc) and float(gr) == float(wr)
    xb = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 24, cfg.d_model)).astype(np.float32)).to(cuda)
    ops.reset_launches()
    y = ssm.mamba_block(on, cfg, xb, pcilt=pcc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dwconv1d"] == 1 and bool(torch.isfinite(y).all())
    with pytest.raises(TypeError, match="float32"):
        ssm.mamba_block(on, dataclasses.replace(cfg, dtype=torch.bfloat16),
                        xb, pcilt=pcc)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["CAUSAL", "VALID"])
def test_fused_dwconv_on_a_channel_slice_equals_plain(cuda, padding):
    """Kernel 2 on a channel block of a wider signal (strided, as a mesh's
    channel shard takes it): each of four blocks, with its block of the
    tables, equals the plain version on the same block, output and
    counters exactly, one launch a block; and ``mamba_block(pcilt=,
    ctx=)`` on a (1, 4) mesh of this card launches it once a channel
    shard, its output within 2e-4 of the unsharded block's."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_ctx
    from repro_torch.nn import ssm
    from repro_torch.nn.module import materialize, place, shardings

    spec = QuantSpec(4, True)
    rng = np.random.default_rng(9)
    C, k, n = 96, 4, 4
    x = torch.from_numpy(rng.normal(0, 0.3, (3, 21, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (k, C)).astype(np.float32))
    tabs = build_dwconv_tables(w, spec, 0.05)
    size = C // n
    for j in range(n):
        xs, ts = x[..., j * size:(j + 1) * size], tabs[j * size:(j + 1) * size]
        assert not xs.is_contiguous()
        want, wc, wr = ops.pcilt_fused_dwconv1d(xs, ts, spec, 0.05, k,
                                                padding, with_stats=True)
        before = ops.LAUNCHES["dwconv1d"]
        got, gc, gr = ops.pcilt_fused_dwconv1d(xs.to(cuda), ts.to(cuda),
                                               spec, 0.05, k, padding,
                                               with_stats=True)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["dwconv1d"] == before + 1
        assert torch.equal(got.cpu(), want)
        assert int(gc) == int(wc) and float(gr) == float(wr)
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    params = materialize(ssm.mamba_spec(cfg), 3, device="cpu")
    xb = torch.from_numpy(rng.normal(0, 1, (4, 24, cfg.d_model))
                          .astype(np.float32))
    want = ssm.mamba_block(params, cfg, xb,
                           pcilt=ssm.build_pcilt_conv(params, cfg, 0.05))
    mesh = make_host_mesh(1, n, devices=[cuda] * n)
    ctx = make_ctx(mesh)
    placed = place(materialize(ssm.mamba_spec(cfg), 3, device=cuda),
                   shardings(ssm.mamba_spec(cfg), mesh))
    pc = ssm.build_pcilt_conv(placed, cfg, 0.05)
    ops.reset_launches()
    got = ctx.join_rows(ssm.mamba_block(placed, cfg, ctx.split_rows(
        xb.to(cuda)), pcilt=pc, ctx=ctx))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dwconv1d"] == n
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 2e-4 * scale


@pytest.mark.cuda
def test_restart_contract_on_the_card(cuda, tmp_path, capsys):
    """``launch.train`` on the card at the smoke config: a fault at step 15
    restores step 10 and ends on the parameters and moments of an
    uninterrupted run, bit for bit."""
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import train

    args = ["--arch", "qwen2.5-3b", "--steps", "20", "--seq", "32",
            "--batch", "4", "--ckpt-every", "10", "--log-every", "10"]
    got = train.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                             "--fail-at", "15"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 10" in out and "restarts=1" in out
    clean = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    for a, b in zip(tree_leaves({"p": got["params"], "o": got["opt"]}),
                    tree_leaves({"p": clean["params"], "o": clean["opt"]})):
        assert a.device.type == "cuda"
        assert torch.equal(a, b)


# -- the design cache's dispatch on the card --------------------------------


def _cache_cases(rng):
    """family -> (launch(autotune) on the card, its plain version, the
    design counter, the shape's admitted designs, sum tolerance or None
    for exact)."""
    from repro_torch.core.lut_layers import flatten_filters

    spec, group = QuantSpec(2, True), 2
    cases = {}
    w = torch.from_numpy(rng.normal(size=(2, 768, 64)).astype(np.float32))
    tabs = torch.stack([build_grouped_tables(w[l], spec, 0.2, group)
                        for l in range(2)])
    x = torch.from_numpy((2 * rng.normal(size=(4, 768))).astype(np.float32))
    cases["fused_gemv_stacked"] = (
        lambda a, t=tabs.cuda(), xc=x.cuda(): ops.pcilt_fused_gemv_stacked(
            xc, t, 1, spec, 0.2, group, autotune=a),
        ops.pcilt_fused_gemv_stacked(x, tabs, 1, spec, 0.2, group),
        ops.GEMV_VARIANT_LAUNCHES, ops.gemv_candidates(4, 384, 64, 4), 1e-4)
    s4 = QuantSpec(2, True)
    filt = torch.from_numpy(rng.normal(size=(4, 96)).astype(np.float32))
    dtab = build_dwconv_tables(filt, s4, 0.3)
    win = torch.from_numpy(rng.normal(size=(4, 4, 96)).astype(np.float32))
    cases["fused_dwconv1d"] = (
        lambda a, t=dtab.cuda(), xc=win.cuda(): ops.pcilt_fused_dwconv1d(
            xc, t, s4, 0.3, 4, "VALID", autotune=a),
        ops.pcilt_fused_dwconv1d(win, dtab, s4, 0.3, 4, "VALID"),
        ops.DWCONV_VARIANT_LAUNCHES, ops.dwconv_candidates(4), None)
    pool = torch.from_numpy(rng.normal(size=(5, 16, 200)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, size=64).astype(np.int32))
    xs = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    cases["shared_gemv"] = (
        lambda a, p=pool.cuda(), i=idx.cuda(), xc=xs.cuda():
            ops.pcilt_shared_gemv(xc, p, i, spec, 0.2, group, autotune=a),
        ops.pcilt_shared_gemv(xs, pool, idx, spec, 0.2, group),
        ops.SHARED_GEMV_VARIANT_LAUNCHES,
        ops.shared_gemv_candidates(4, 64, 200, 4), 1e-4)
    cf = torch.from_numpy(rng.normal(size=(3, 3, 4, 40)).astype(np.float32))
    ctab = build_grouped_tables(flatten_filters(cf, group), spec, 0.3, group)
    img = torch.from_numpy(rng.uniform(-1, 2, (1, 20, 24, 4))
                           .astype(np.float32))
    cases["fused_conv2d"] = (
        lambda a, t=ctab.cuda(), xc=img.cuda(): ops.pcilt_fused_conv2d(
            xc, t, spec, 0.3, group, 3, 3, autotune=a),
        ops.pcilt_fused_conv2d(img, ctab, spec, 0.3, group, 3, 3),
        ops.CONV_VARIANT_LAUNCHES, ops.conv_candidates(16, 4), 1e-4)
    htab = torch.from_numpy(rng.normal(size=(30, 16, 50)).astype(np.float32))
    off = torch.from_numpy(rng.integers(0, 16, (4, 30)).astype(np.int32))
    cases["gemv_host"] = (
        lambda a, t=htab.cuda(), o=off.cuda(): ops.pcilt_gemv(
            o, t, autotune=a),
        ops.pcilt_gemv(off, htab), ops.GEMV_HOST_VARIANT_LAUNCHES,
        ops.gemv_host_candidates(4, 30, 16, 50, 4), 1e-4)
    wtab = torch.from_numpy(rng.normal(size=(40, 256)).astype(np.float32))
    woff = torch.from_numpy(rng.integers(0, 256, (2, 9, 40)).astype(np.int32))
    cases["dwconv1d_host"] = (
        lambda a, t=wtab.cuda(), o=woff.cuda(): ops._dwconv1d_host(
            o, t, autotune=a),
        pcilt_dwconv1d_ref(woff, wtab), ops.DWCONV_HOST_VARIANT_LAUNCHES,
        ops.dwconv_host_candidates(256, 4), None)
    return cases


CACHE_FAMILIES = ["fused_gemv_stacked", "fused_dwconv1d", "shared_gemv",
                  "fused_conv2d", "gemv_host", "dwconv1d_host"]


@pytest.mark.cuda
@pytest.mark.parametrize("family", CACHE_FAMILIES)
def test_cached_design_runs_and_matches_plain(cuda, family, tmp_path):
    """Each design the cache can choose: tuned in (an injected clock makes
    it win), then dispatched from the warm cache by a fresh memo — the
    launch runs that design, times nothing, and matches the plain version;
    a forced design still wins over the cache."""
    from repro_torch.kernels import autotune as atn

    run, want, counter, cands, rtol = _cache_cases(
        np.random.default_rng(3))[family]
    path = str(tmp_path / "tiles.json")
    try:
        for design in cands:
            atn.reset_cache(str(tmp_path / f"{design}.json"))
            times = [1.0 if c == design else 2.0 for c in cands]
            it = iter(times)
            with atn.using_timer(lambda fn, reps, warmup: (fn(), next(it))[1]):
                run(True)
            recorded = atn.get_cache().entries()
            assert [e["design"] for e in recorded.values()] == [design]
            assert all("|backend=cuda:" in k for k in recorded)
            atn.reset_cache(str(tmp_path / f"{design}.json"))
            atn.TIMING_RUNS = 0
            before = dict(counter)
            got = run(None)
            torch.cuda.synchronize()
            assert atn.TIMING_RUNS == 0
            assert counter[design] == before[design] + 1, (design, counter)
            if rtol is None:
                assert torch.equal(got.cpu(), want)
            else:
                _assert_sum_close(got.cpu(), want, rtol)
        if family == "fused_gemv_stacked":  # forced beats cached
            other = [c for c in cands if c != cands[-1]][0]
            before = dict(counter)
            with ops._gemv_forced(other):
                run(None)
            assert counter[other] == before[other] + 1
    finally:
        atn.reset_cache(path)


@pytest.mark.cuda
def test_tuning_on_the_card_times_then_hits(cuda, tmp_path):
    """``autotune=True`` on a CUDA tensor times the candidates with CUDA
    events (a miss) and records a finite ``us``; a fresh process on the
    same file times nothing."""
    from repro_torch.kernels import autotune as atn

    run, want, _, cands, rtol = _cache_cases(
        np.random.default_rng(4))["fused_gemv_stacked"]
    path = str(tmp_path / "tiles.json")
    try:
        atn.reset_cache(path)
        atn.TIMING_RUNS = 0
        run(True)
        assert atn.TIMING_RUNS > 0
        (entry,) = atn.get_cache().entries().values()
        assert entry["design"] in cands and entry["us"] > 0
        assert entry["candidates"] == len(cands)
        atn.reset_cache(path)
        atn.TIMING_RUNS = 0
        _assert_sum_close(run(True).cpu(), want, rtol)
        assert atn.TIMING_RUNS == 0
    finally:
        atn.reset_cache(str(tmp_path / "after.json"))


@pytest.mark.cuda
def test_granite_expert_parallel_on_card_matches_cpu(cuda):
    """granite's smoke config on a (1, 2) mesh of this card (the
    all-to-all prefill and the psum decode step of ``nn.moe``) against the
    same mesh on the CPU: the logits within 2e-2 of the largest, the
    averaged aux losses of ``loss(ctx=)`` within 2e-2 relative."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize, place, shardings

    cfg = get_smoke_config("granite-moe-3b-a800m")
    m = build_model(cfg)
    params = materialize(m.param_specs(), 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 8)))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = make_host_mesh(1, 2, devices=[dev] * 2)
        p = place(params, shardings(m.param_specs(), mesh))
        with torch.no_grad():
            pre, cache = make_prefill_step(cfg, mesh)(p, {"tokens": toks})
            dec, _ = make_decode_step(cfg, mesh)(p, cache, toks[:, :1])
            _, met = m.loss(p, {"tokens": toks, "labels": toks},
                            ctx=make_ctx(mesh))
        runs[dev.type] = [pre.float().cpu(), dec.float().cpu()[:, :cfg.vocab],
                          met]
    for got, want in zip(runs["cuda"][:2], runs["cpu"][:2]):
        assert float((got - want).abs().max()) <= \
            2e-2 * float(want.abs().max())
    for k in ("load_balance", "router_z"):
        g, w = float(runs["cuda"][2][k]), float(runs["cpu"][2][k])
        assert abs(g - w) <= 2e-2 * abs(w), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_dry_run_counts_what_the_card_runs(cuda, kind):
    """The dry run's gates on a (1, 2) mesh of this card: a qwen3 smoke
    step counted on meta tensors and the same step counted on the card
    (seeded weights) give each coordinate the same argument bytes, flops
    and moves by kind."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import data_spec, step_args
    from repro_torch.models import build_model
    from repro_torch.nn.module import (materialize, place, shape_structs,
                                       shardings)

    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(6)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                        dtype=torch.int32)
    got = {}
    for dev in ("meta", "cuda:0"):
        mesh = make_host_mesh(1, 2, devices=[dev] * 2)
        rules = data_spec(mesh)
        specs = {"params": model.param_specs()}
        if kind == "decode":
            specs["cache"] = model.cache_specs(4, 32)
        if dev == "meta":
            args = step_args({k: shape_structs(v, mesh, rules)
                              for k, v in specs.items()})
        else:
            args = {k: place(materialize(v, 0, device=cuda),
                             shardings(v, mesh, rules))
                    for k, v in specs.items()}
        if kind == "decode":
            args["cache"]["pos"] = 31
            args["tokens"] = tok[:, :1].to(dev)
        else:
            args["batch"] = {"tokens": tok.to(dev)}
        r = dryrun.measure_step(dryrun.make_step(cfg, kind, mesh), kind,
                                args, mesh)
        assert r["crossed"] == 0
        got[dev] = r["per_coord"]
    assert sorted(got["meta"]) == sorted(got["cuda:0"]) == ["0,0", "0,1"]
    for c, m in got["meta"].items():
        k = got["cuda:0"][c]
        for key in ("argument_bytes", "flops", "collective_bytes", "coll"):
            assert m[key] == k[key], (c, key)
