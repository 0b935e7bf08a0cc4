"""Port parity: the plain versions of the three ported kernels against the
JAX package's kernels (``repro.kernels.ops``, Pallas in interpret mode on
the CPU), on JAX-built tables and ragged shapes.

On CPU tensors the port's wrappers run their plain versions, so these tests
hold the formula each CUDA kernel implements to the reference; the kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the dwconv fetch and every saturation counter are exact.  A
GEMV sums G float32 rows in another order than the reference's one-hot
contraction, so float32 outputs agree to 1e-6 (bit-equal on an exact grid:
small-integer weights, power-of-two scale); bfloat16 tables round that
float32 sum once, so they may differ by one bf16 step (rtol 1e-2).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lut_layers as jl
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.kernels import autotune as atn
from repro.kernels import ops as jops
from repro_torch.core import quantization as tq
from repro_torch.interop import to_torch
from repro_torch.kernels import ops as tops


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _compare(got, want, dtype, exact):
    got = got.float().numpy()
    want = _np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _grouped_stack(rng, L, G, group, bits, O, exact, scales):
    spec = jq.QuantSpec(bits, True)
    ws = (rng.integers(-3, 4, size=(L, G * group, O)) if exact
          else rng.normal(size=(L, G * group, O))).astype(np.float32)
    return jnp.stack([jp.build_grouped_tables(jnp.asarray(ws[l]), spec,
                                              jnp.float32(scales[l]), group)
                      for l in range(L)])


STACKED = [  # B, L, G, group, bits, O, table dtype, exact grid
    (3, 2, 5, 2, 2, 7, "float32", False),
    (4, 3, 6, 2, 4, 130, "float32", False),
    (4, 2, 6, 2, 4, 130, "float32", True),
    (1, 2, 4, 2, 4, 24, "bfloat16", False),
    (4, 2, 3, 3, 2, 129, "float32", False),
]


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("B,L,G,group,bits,O,dtype,exact", STACKED)
def test_gemv_stacked_plain_matches_reference(B, L, G, group, bits, O, dtype,
                                              exact, with_stats):
    rng = np.random.default_rng(B * 100 + G * 10 + O)
    scales = np.full(L, 0.5, np.float32) if exact else \
        rng.uniform(0.1, 0.4, size=L).astype(np.float32)
    tabs = _grouped_stack(rng, L, G, group, bits, O, exact, scales)
    tabs = tabs.astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, G * group))).astype(np.float32)
    layer = L - 1
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    want = jops.pcilt_fused_gemv_stacked(jnp.asarray(x), tabs, layer, sj,
                                         scales[layer], group,
                                         with_stats=with_stats)
    got = tops.pcilt_fused_gemv_stacked(torch.from_numpy(x), to_torch(tabs),
                                        layer, st, float(scales[layer]),
                                        group, with_stats=with_stats)
    if with_stats:
        (got, gc, gr), (want, wc, wr) = got, want
        assert gc.dtype == torch.int32 and int(gc) == int(wc)
        assert float(gr) == float(wr)
        assert int(gc) > 0  # the spread saturates some activations
    assert got.dtype == getattr(torch, dtype)
    _compare(got, want, dtype, exact)


DWCONV = [  # B, T, C, k, bits, padding, table dtype
    (4, 4, 33, 4, 4, "VALID", "float32"),
    (3, 7, 20, 4, 2, "CAUSAL", "float32"),
    (2, 6, 9, 3, 4, "SAME", "bfloat16"),
    (2, 5, 130, 2, 4, "VALID", "float32"),
]


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("B,T,C,k,bits,padding,dtype", DWCONV)
def test_dwconv1d_plain_matches_reference(B, T, C, k, bits, padding, dtype,
                                          with_stats):
    rng = np.random.default_rng(B * 1000 + T * 100 + C)
    filt = rng.normal(size=(k, C)).astype(np.float32)
    scale = np.float32(0.3)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    tabs = jl.build_dwconv_tables(jnp.asarray(filt), sj, jnp.float32(scale))
    tabs = tabs.astype(jnp.dtype(dtype))
    x = (1.5 * rng.normal(size=(B, T, C))).astype(np.float32)
    want = jops.pcilt_fused_dwconv1d(jnp.asarray(x), tabs, sj, scale, k,
                                     padding=padding, with_stats=with_stats)
    got = tops.pcilt_fused_dwconv1d(torch.from_numpy(x), to_torch(tabs), st,
                                    float(scale), k, padding=padding,
                                    with_stats=with_stats)
    if with_stats:
        (got, gc, gr), (want, wc, wr) = got, want
        assert int(gc) == int(wc) > 0 and float(gr) == float(wr)
    _compare(got, want, dtype, exact=True)  # one fetch per output


SHARED = [  # B, G, group, bits, X, O, pool dtype, exact grid
    (3, 6, 2, 4, 3, 130, "float32", False),
    (4, 8, 2, 2, 2, 7, "bfloat16", False),
    (4, 8, 2, 4, 5, 33, "float32", True),
]


@pytest.mark.parametrize("B,G,group,bits,X,O,dtype,exact", SHARED)
def test_shared_gemv_plain_matches_reference(B, G, group, bits, X, O, dtype,
                                             exact):
    rng = np.random.default_rng(B * 100 + G * 10 + X)
    blocks = (rng.integers(-3, 4, size=(X, group, O)) if exact
              else rng.normal(size=(X, group, O))).astype(np.float32)
    w = blocks[rng.permutation(np.arange(G) % X)].reshape(G * group, O)
    scale = np.float32(0.5 if exact else 0.21)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    sh = jp.build_shared_grouped_tables(jnp.asarray(w), sj, jnp.float32(scale),
                                        group)
    pool = sh.pool.astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, G * group))).astype(np.float32)
    want = jops.pcilt_shared_gemv(jnp.asarray(x), pool, sh.seg_idx, sj, scale,
                                  group)
    got = tops.pcilt_shared_gemv(torch.from_numpy(x), to_torch(pool),
                                 to_torch(np.asarray(sh.seg_idx, np.int32)),
                                 st, float(scale), group)
    assert got.dtype == getattr(torch, dtype)
    _compare(got, want, dtype, exact)


def test_shared_gemv_plain_skips_out_of_range_pointers():
    """A pointer outside [0, X) selects no pool row, as the reference
    kernel's pointer-select does."""
    rng = np.random.default_rng(3)
    spec = tq.QuantSpec(4, True)
    pool = torch.from_numpy(rng.normal(size=(2, 256, 5)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    full = tops.pcilt_shared_gemv(x, pool, idx, spec, 0.3, 2)
    bad = tops.pcilt_shared_gemv(x, pool, torch.tensor([0, 7, 1],
                                                       dtype=torch.int32),
                                 spec, 0.3, 2)
    only = tops.pcilt_shared_gemv(x[:, 2:4], pool,
                                  torch.tensor([1], dtype=torch.int32),
                                  spec, 0.3, 2)
    torch.testing.assert_close(bad, full - only, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_bad_operands():
    spec = tq.QuantSpec(4, True)
    tabs = torch.zeros(2, 3, 256, 4)
    with pytest.raises(ValueError):
        tops.pcilt_fused_gemv_stacked(torch.zeros(2, 5), tabs, 0, spec, 1.0, 2)
    with pytest.raises(IndexError):
        tops.pcilt_fused_gemv_stacked(torch.zeros(2, 6), tabs, 2, spec, 1.0, 2)
    with pytest.raises(ValueError):
        tops.pcilt_fused_dwconv1d(torch.zeros(1, 4, 3), torch.zeros(4, 256),
                                  spec, 1.0, 2)
    with pytest.raises(ValueError):
        tops.pcilt_fused_gemv_stacked(torch.zeros(2, 6), tabs, 0, spec,
                                      torch.ones(2), 2)
    with pytest.raises(TypeError):
        tops.pcilt_shared_gemv(torch.zeros(2, 6), torch.zeros(2, 256, 4),
                               torch.zeros(3, dtype=torch.int64), spec, 1.0, 2)
    # the plain versions never count as kernel launches
    assert all(v == 0 for v in tops.LAUNCHES.values())


# ----------------------------------------------------------------------------
# core.lut_layers: the reference paths against the JAX package's
# ----------------------------------------------------------------------------


def test_pcilt_linear_paths_match_reference():
    """``gather`` on dense, stacked and shared tables, and the stacked
    ``fused`` / ``shared`` routes (plain versions here), against the JAX
    package's ``pcilt_linear`` ``gather``, stats included."""
    from repro.core import lut_layers as jll
    from repro_torch.core import SharedGroupedTables, pcilt_linear

    rng = np.random.default_rng(21)
    bits, group, G, O, L = 4, 2, 6, 9, 3
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    scales = rng.uniform(0.2, 0.4, size=L).astype(np.float32)
    tabs = _grouped_stack(rng, L, G, group, bits, O, False, scales)
    x = (2.0 * rng.normal(size=(2, 3, G * group))).astype(np.float32)
    xt, tt = torch.from_numpy(x), to_torch(tabs)
    for path in ("gather", "fused"):
        got, gc, gr = pcilt_linear(xt, tt, st, float(scales[1]), group,
                                   path=path, stacked=1, return_stats=True)
        want, wc, wr = jll.pcilt_linear(jnp.asarray(x), tabs, sj, scales[1],
                                        group, path="gather", stacked=1,
                                        return_stats=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert int(gc) == int(wc) and float(gr) == float(wr)
    blocks = rng.normal(size=(2, group, O)).astype(np.float32)
    w = blocks[np.arange(G) % 2].reshape(G * group, O)
    sh = jp.build_shared_grouped_tables(jnp.asarray(w), sj, scales[0], group)
    want = jll.pcilt_linear(jnp.asarray(x), sh, sj, scales[0], group,
                            path="gather")
    tsh = SharedGroupedTables(pool=to_torch(sh.pool),
                              seg_idx=to_torch(np.asarray(sh.seg_idx)),
                              group=group)
    for path in ("gather", "shared"):
        got = pcilt_linear(xt, tsh, st, float(scales[0]), group, path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        pcilt_linear(xt, tt[0], st, 0.3, group, path="plan")


@pytest.mark.parametrize("padding", ["CAUSAL", "SAME", "VALID"])
@pytest.mark.parametrize("path", ["gather", "fused"])
def test_depthwise_conv1d_paths_match_reference(path, padding):
    """The port's ``gather`` and ``fused`` (plain) dwconv against the same
    path of the JAX package: one fetch per output, so exact.  (The two
    paths differ at CAUSAL/SAME edges in both packages: ``gather`` pads the
    codes with 0, ``fused`` pads the signal with 0.0, i.e. the zero point.)"""
    from repro.core import lut_layers as jll
    from repro_torch.core import pcilt_depthwise_conv1d

    rng = np.random.default_rng(22)
    filt = rng.normal(size=(4, 10)).astype(np.float32)
    x = (1.5 * rng.normal(size=(2, 7, 10))).astype(np.float32)
    sj, st = jq.QuantSpec(4, True), tq.QuantSpec(4, True)
    want, wc, wr = jll.pcilt_depthwise_conv1d(
        jnp.asarray(x), jnp.asarray(filt), sj, jnp.float32(0.3), path=path,
        padding=padding, return_stats=True)
    got, gc, gr = pcilt_depthwise_conv1d(
        torch.from_numpy(x), torch.from_numpy(filt), st, 0.3, path=path,
        padding=padding, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gc) == int(wc) and float(gr) == float(wr)
