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
