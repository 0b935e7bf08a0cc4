"""Port parity: the single-layer PCILT API and its two kernels.

* ``ops.pcilt_fused_gemv`` (the unstacked fused GEMV) and
  ``ops.pcilt_dwconv1d`` (the host-packed depthwise fetch), whose plain
  versions run for CPU tensors, against the JAX package's Pallas kernels in
  interpret mode: the GEMV bit-equal on exact grids (small-integer weights,
  power-of-two scale), float32 within rtol = atol = 1e-6 elsewhere
  (another summation order), bfloat16 within 1e-2 (one rounding of the
  float32 sum); the dwconv fetch exact;
* ``convert_kernel`` -> ``PCILTLinear`` on every path (fused, gather,
  onehot, kernel, shared; ``weight_bits``; an odd reduction length) against
  the JAX layer on the same weights and scale, within 1e-5 (float32 sums
  in another order), with the same table bytes and integrity behaviour;
* ``convert_dwconv`` -> ``PCILTDwConv1d`` on fused, gather, onehot and
  kernel under CAUSAL, SAME and VALID against the JAX layer: exact (one
  fetch per output);
* ``mlp_table_bytes`` equal to the reference's.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.core import serving as js
from repro.kernels import ops as jops
from repro_torch.core import pcilt as tp
from repro_torch.core import quantization as tq
from repro_torch.core import serving as ts
from repro_torch.core.lut_layers import build_dwconv_tables
from repro_torch.interop import to_torch
from repro_torch.kernels import ops as tops


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


FUSED = [  # B, G, group, bits, O, table dtype, exact grid
    (3, 5, 2, 4, 13, "float32", False),
    (4, 6, 2, 4, 130, "float32", False),
    (4, 6, 2, 4, 130, "float32", True),
    (2, 8, 2, 2, 24, "bfloat16", False),
    (1, 7, 1, 4, 129, "float32", False),
]


@pytest.mark.parametrize("B,G,group,bits,O,dtype,exact", FUSED)
def test_fused_gemv_plain_matches_reference(B, G, group, bits, O, dtype,
                                            exact):
    rng = np.random.default_rng(B * 100 + G * 10 + O)
    n = G * group
    w = (rng.integers(-3, 4, size=(n, O)) if exact
         else rng.normal(size=(n, O))).astype(np.float32)
    scale = np.float32(0.5 if exact else 0.19)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    tabs = jp.build_grouped_tables(jnp.asarray(w), sj, scale,
                                   group).astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, n))).astype(np.float32)
    want = _f32(jops.pcilt_fused_gemv(jnp.asarray(x), tabs, sj, scale, group))
    got = tops.pcilt_fused_gemv(torch.from_numpy(x), to_torch(tabs), st,
                                float(scale), group)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-2 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,T,C,V,dtype", [(2, 5, 130, 256, "float32"),
                                           (3, 4, 9, 16, "bfloat16"),
                                           (1, 7, 128, 65536, "float32")])
def test_dwconv1d_host_plain_matches_reference(B, T, C, V, dtype):
    rng = np.random.default_rng(C + V)
    tabs = rng.normal(size=(C, V)).astype(np.float32)
    tabs = jnp.asarray(tabs).astype(jnp.dtype(dtype))
    off = rng.integers(0, V, size=(B, T, C)).astype(np.int32)
    want = _f32(jops.pcilt_dwconv1d(jnp.asarray(off), tabs))
    got = tops.pcilt_dwconv1d(torch.from_numpy(off), to_torch(tabs))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dwconv1d_host_out_of_range_offsets_fetch_zero():
    """An offset outside [0, V) matches none of the reference kernel's V
    masked terms: its output is 0."""
    tabs = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    off = np.array([[[0, 4, -1], [3, 2, 9]]], np.int32)
    want = np.asarray(jops.pcilt_dwconv1d(jnp.asarray(off), jnp.asarray(tabs)))
    got = tops.pcilt_dwconv1d(torch.from_numpy(off), torch.from_numpy(tabs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 1] == 0 and got[0, 1, 2] == 0


def test_single_layer_wrappers_reject_bad_operands():
    spec = tq.QuantSpec(4, True)
    with pytest.raises(ValueError):  # n != G * group
        tops.pcilt_fused_gemv(torch.zeros(2, 5), torch.zeros(3, 256, 4),
                              spec, 1.0, 2)
    with pytest.raises(TypeError):
        tops.pcilt_dwconv1d(torch.zeros(1, 2, 3, dtype=torch.int64),
                            torch.zeros(3, 16))
    with pytest.raises(ValueError):
        tops.pcilt_dwconv1d(torch.zeros(1, 2, 4, dtype=torch.int32),
                            torch.zeros(3, 16))
    assert all(v == 0 for v in tops.LAUNCHES.values())


# ----------------------------------------------------------------------------
# PCILTLinear / convert_kernel
# ----------------------------------------------------------------------------


LINEAR = {  # name: (n, out, weight_bits, shared)
    "dense": (24, 10, None, False),
    "odd_n": (23, 10, None, False),
    "weight_bits": (24, 10, 2, False),
    "shared": (24, 10, 2, True),
}


@pytest.mark.parametrize("case", sorted(LINEAR))
def test_pcilt_linear_layer_matches_reference(case):
    n, out, wbits, shared = LINEAR[case]
    rng = np.random.default_rng(len(case) * 7 + n)
    kernel = rng.normal(size=(n, out)).astype(np.float32)
    x = (1.5 * rng.normal(size=(2, 3, n))).astype(np.float32)
    sj, st = jq.QuantSpec(4, True), tq.QuantSpec(4, True)
    scale = np.float32(0.21)
    jlay = js.convert_kernel(jnp.asarray(kernel), sj, jnp.float32(scale), 2,
                             weight_bits=wbits, shared=shared)
    tlay = ts.convert_kernel(torch.from_numpy(kernel), st, float(scale), 2,
                             weight_bits=wbits, shared=shared)
    assert tlay.n_segments == jlay.n_segments
    assert tlay.table_bytes() == jlay.table_bytes()
    assert tlay.verify_integrity() == jlay.verify_integrity()
    assert all(tlay.verify_integrity().values())
    if shared:
        np.testing.assert_array_equal(tlay.shared.pool.numpy(),
                                      np.asarray(jlay.shared.pool))
        paths = ("shared", "gather")
    else:
        np.testing.assert_array_equal(tlay.tables.numpy(),
                                      np.asarray(jlay.tables))
        paths = ("fused", "gather", "onehot", "kernel")
    for path in paths:
        want = np.asarray(jlay(jnp.asarray(x), path=path))
        got = ts.pcilt_apply(tlay, torch.from_numpy(x), path=path)
        assert got.shape == (2, 3, out)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    with pytest.raises(ValueError):  # the other representation is absent
        tlay(torch.from_numpy(x), path="fused" if shared else "shared")


def test_pcilt_linear_layer_integrity_breach():
    rng = np.random.default_rng(3)
    lay = ts.convert_kernel(torch.from_numpy(
        rng.normal(size=(8, 5)).astype(np.float32)), tq.QuantSpec(4, True),
        0.3, 2)
    assert lay.verify_integrity() == {"tables": True}
    lay.tables.view(torch.int32)[1, 7, 2] ^= 1
    assert lay.verify_integrity() == {"tables": False}


def test_pcilt_linear_fused_runs_one_kernel_call(monkeypatch):
    """``path='fused'`` is one call of the fused GEMV wrapper over the
    flattened rows."""
    calls = []
    real = tops.pcilt_fused_gemv

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return real(x, *a, **k)

    monkeypatch.setattr(tops, "pcilt_fused_gemv", spy)
    rng = np.random.default_rng(4)
    lay = ts.convert_kernel(torch.from_numpy(
        rng.normal(size=(12, 6)).astype(np.float32)), tq.QuantSpec(4, True),
        0.3, 2)
    lay(torch.from_numpy(rng.normal(size=(2, 3, 12)).astype(np.float32)),
        path="fused")
    assert calls == [(6, 12)]


# ----------------------------------------------------------------------------
# PCILTDwConv1d / convert_dwconv
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("padding", ["CAUSAL", "SAME", "VALID"])
@pytest.mark.parametrize("path", ["fused", "gather", "onehot", "kernel"])
def test_pcilt_dwconv_layer_matches_reference(path, padding):
    """Exact: one fetch per output.  (The host-packed paths pad the codes
    with 0 at CAUSAL/SAME edges, the fused path the signal with 0.0, in
    both packages.)"""
    rng = np.random.default_rng(23)
    filt = rng.normal(size=(4, 12)).astype(np.float32)
    x = (1.5 * rng.normal(size=(2, 9, 12))).astype(np.float32)
    sj, st = jq.QuantSpec(2, True), tq.QuantSpec(2, True)
    jlay = js.convert_dwconv(jnp.asarray(filt), sj, jnp.float32(0.4))
    tlay = ts.convert_dwconv(torch.from_numpy(filt), st, 0.4)
    np.testing.assert_array_equal(tlay.tables.numpy(),
                                  np.asarray(jlay.tables))
    assert tlay.table_bytes() == jlay.table_bytes()
    want = np.asarray(jlay(jnp.asarray(x), path=path, padding=padding))
    got = tlay(torch.from_numpy(x), path=path, padding=padding)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dwconv_kernel_path_equals_fused_past_the_edge():
    """The host-packed and fused paths agree from t >= k - 1 (CAUSAL), where
    no pad reaches the window."""
    rng = np.random.default_rng(8)
    filt = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    x = torch.from_numpy((2 * rng.normal(size=(2, 11, 16))).astype(np.float32))
    lay = ts.convert_dwconv(filt, tq.QuantSpec(2, True), 0.5)
    assert torch.equal(lay.tables, build_dwconv_tables(
        filt, tq.QuantSpec(2, True), 0.5))
    a = lay(x, path="kernel")
    b = lay(x, path="fused")
    assert torch.equal(a[:, 3:], b[:, 3:])


@pytest.mark.parametrize("d_model,d_ff,bits,group,vb", [
    (1024, 3072, 4, 2, 4), (64, 128, 2, 2, 2), (768, 2048, 8, 1, 2)])
def test_mlp_table_bytes_match_reference(d_model, d_ff, bits, group, vb):
    assert ts.mlp_table_bytes(d_model, d_ff, bits, group, vb) == \
        js.mlp_table_bytes(d_model, d_ff, bits, group, vb)
    # the qwen3-0.6b MLP the chip smoke runs: 1.61 GB of float32 tables per
    # projection at 4-bit activations, group 2
    if d_model == 1024:
        assert ts.mlp_table_bytes(d_model, d_ff, bits, group, vb) == \
            3 * 512 * 256 * 3072 * 4
        assert tp.grouped_table_bytes(1024 * 3072, 4, 2, 4) == \
            512 * 256 * 3072 * 4
