"""Port parity: quantization and offset packing.

The same seeded numpy inputs go through ``repro.core`` (JAX) and
``repro_torch.core``; codes, saturation counts, ratios, fake-quant values
and packed offsets must be bit-equal, exact ``.5`` ties included (both
round half to even after a true division).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import offsets as joff
from repro.core import quantization as jq
from repro_torch.core import offsets as toff
from repro_torch.core import quantization as tq

SPECS = [(2, False), (2, True), (4, True), (4, False), (8, True)]


def _x(seed, shape=(5, 24), spread=3.0):
    rng = np.random.default_rng(seed)
    return (spread * rng.normal(size=shape)).astype(np.float32)


def _ties(scale, bits):
    """Values landing exactly on ``k + 0.5`` code steps of ``scale``."""
    k = np.arange(-(1 << bits), 1 << bits, dtype=np.float32)
    return ((k + np.float32(0.5)) * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("bits,sym", SPECS)
def test_quantize_bit_equal_with_ties(bits, sym):
    spec_j, spec_t = jq.QuantSpec(bits, sym), tq.QuantSpec(bits, sym)
    scale = np.float32(0.25)  # a power of two: the ties are exact
    x = np.concatenate([_x(bits).ravel(), _ties(scale, bits)])
    want = np.asarray(jq.quantize(jnp.asarray(x), spec_j, jnp.float32(scale)))
    got = tq.quantize(torch.from_numpy(x), spec_t, torch.tensor(scale)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,sym", SPECS)
def test_quantize_with_stats_bit_equal(bits, sym):
    spec_j, spec_t = jq.QuantSpec(bits, sym), tq.QuantSpec(bits, sym)
    x = _x(10 + bits, spread=5.0)
    scale = np.float32(7.4 / (1 << bits))  # the grid spans about +-3.7
    jc, jn, jr = jq.quantize_with_stats(jnp.asarray(x), spec_j,
                                        jnp.float32(scale))
    tc, tn, tr = tq.quantize_with_stats(torch.from_numpy(x), spec_t,
                                        torch.tensor(scale))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tn.dtype == torch.int32 and int(tn) == int(jn)
    assert tr.dtype == torch.float32 and float(tr) == float(jr)
    assert int(tn) > 0  # the spread saturates some elements


@pytest.mark.parametrize("bits,sym", SPECS)
def test_fake_quant_and_ste_gradient(bits, sym):
    spec_j, spec_t = jq.QuantSpec(bits, sym), tq.QuantSpec(bits, sym)
    x = _x(20 + bits)
    scale = np.float32(0.3)
    want = np.asarray(jq.fake_quant(jnp.asarray(x), spec_j, jnp.float32(scale)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq.fake_quant(xt, spec_t, torch.tensor(scale))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(
        jq.fake_quant(v, spec_j, jnp.float32(scale)) * 2.0))(jnp.asarray(x)))
    (got * 2.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), gj)


@pytest.mark.parametrize("bits,sym", SPECS)
def test_scale_code_values_dequantize(bits, sym):
    spec_j, spec_t = jq.QuantSpec(bits, sym), tq.QuantSpec(bits, sym)
    amax = np.float32(2.7)
    sj = jq.scale_from_amax(jnp.float32(amax), spec_j)
    st = tq.scale_from_amax(torch.tensor(amax), spec_t)
    assert float(st) == float(sj)
    np.testing.assert_array_equal(
        tq.code_values(spec_t, st).numpy(),
        np.asarray(jq.code_values(spec_j, sj)))
    assert float(tq.scale_from_amax(0.0, spec_t)) == float(
        jq.scale_from_amax(0.0, spec_j))


@pytest.mark.parametrize("bits,group", [(2, 2), (4, 2), (4, 4), (1, 8),
                                        (3, 3)])
def test_pack_unpack_offsets_bit_equal(bits, group):
    rng = np.random.default_rng(bits * 10 + group)
    codes = rng.integers(0, 1 << bits, size=(3, 4 * group)).astype(np.uint8)
    want = np.asarray(joff.pack_offsets(jnp.asarray(codes), bits, group))
    got = toff.pack_offsets(torch.from_numpy(codes), bits, group)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        toff.unpack_offsets(got, bits, group).numpy(), codes)
    np.testing.assert_array_equal(
        toff.offset_grid(bits, group).numpy(),
        np.asarray(joff.offset_grid(bits, group)))


def test_quant_spec_validation():
    with pytest.raises(ValueError):
        tq.QuantSpec(bits=9)
    with pytest.raises(ValueError):
        tq.QuantSpec(bits=1, symmetric=True)
    with pytest.raises(ValueError):
        toff.pack_offsets(torch.zeros(2, 6, dtype=torch.uint8), 8, 4)
