"""Port parity: table builds and integrity checksums.

Grouped, depthwise-conv and shared-pool builds of ``repro_torch.core`` must
equal ``repro.core``'s bit for bit on exact grids (small-integer weights, a
power-of-two scale) and to float32 rounding otherwise.  ``table_checksum``
must give the reference's CRC-32 for float32, bfloat16 and int32 arrays,
and the streamed CRC must equal the CRC of the whole byte string.
"""

import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lut_layers as jl
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro_torch.core import lut_layers as tl
from repro_torch.core import pcilt as tp
from repro_torch.core import quantization as tq
from repro_torch.interop import to_numpy, to_torch

# symmetric 4-bit grid: float32 products of small integers and powers of two
# are exact, so both builds must be bit-equal whatever their summation order
EXACT_SCALE = np.float32(0.5)


def _weights(seed, shape, exact):
    rng = np.random.default_rng(seed)
    if exact:
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("bits,group,n,out", [(4, 2, 12, 7), (2, 2, 8, 130),
                                              (2, 3, 9, 5)])
def test_grouped_tables_match(exact, bits, group, n, out):
    w = _weights(n * out + bits, (n, out), exact)
    scale = EXACT_SCALE if exact else np.float32(0.137)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    want = np.asarray(jp.build_grouped_tables(jnp.asarray(w), sj,
                                              jnp.float32(scale), group))
    got = tp.build_grouped_tables(torch.from_numpy(w), st, float(scale),
                                  group).numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_dwconv_tables_match(exact):
    filt = _weights(3, (4, 33), exact)
    scale = EXACT_SCALE if exact else np.float32(0.211)
    sj, st = jq.QuantSpec(4, True), tq.QuantSpec(4, True)
    want = np.asarray(jl.build_dwconv_tables(jnp.asarray(filt), sj,
                                             jnp.float32(scale)))
    got = tl.build_dwconv_tables(torch.from_numpy(filt), st,
                                 float(scale)).numpy()
    assert got.shape == (33, 1 << 16)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_shared_pool_matches(exact, monkeypatch):
    rng = np.random.default_rng(5)
    # 12 segments drawn from 4 distinct [2, out] blocks: the pool dedupes
    base = _weights(6, (4, 2, 9), exact)
    w = base[rng.integers(0, 4, size=12)].reshape(24, 9)
    scale = EXACT_SCALE if exact else np.float32(0.173)
    sj, st = jq.QuantSpec(4, True), tq.QuantSpec(4, True)
    want = jp.build_shared_grouped_tables(jnp.asarray(w), sj,
                                          jnp.float32(scale), 2)
    monkeypatch.setattr(tp, "POOL_BUILD_ROWS", 3)  # more than one step
    got = tp.build_shared_grouped_tables(torch.from_numpy(w), st,
                                         float(scale), 2)
    assert got.pool.shape[0] == want.pool_cardinality <= 4
    np.testing.assert_array_equal(got.seg_idx.numpy(),
                                  np.asarray(want.seg_idx))
    if exact:
        np.testing.assert_array_equal(got.pool.numpy(), np.asarray(want.pool))
    else:
        np.testing.assert_allclose(got.pool.numpy(), np.asarray(want.pool),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.pool.numpy()[got.seg_idx.numpy()],
                                  np.asarray(want.materialize()))


def _arrays():
    rng = np.random.default_rng(9)
    f = rng.normal(size=(3, 5, 7)).astype(np.float32)
    return {"float32": f,
            "bfloat16": f.astype(ml_dtypes.bfloat16),
            "int32": rng.integers(-1000, 1000, size=(3, 11)).astype(np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_checksum_matches_reference(dtype):
    a = _arrays()[dtype]
    t = to_torch(a)
    assert tp.table_checksum(t) == jp.table_checksum(jnp.asarray(a))
    assert tp.stacked_checksums(t) == jp.stacked_checksums(jnp.asarray(a))
    np.testing.assert_array_equal(np.asarray(to_numpy(t)), a)


@pytest.mark.parametrize("chunk", [1, 5, 64, 1 << 20])
def test_streamed_checksum_equals_whole(chunk, monkeypatch):
    a = _arrays()["float32"]
    monkeypatch.setattr(tp, "CRC_CHUNK_BYTES", chunk)
    assert tp.table_checksum(torch.from_numpy(a)) == zlib.crc32(a.tobytes())
    assert tp.table_checksum(a) == zlib.crc32(a.tobytes())
    # a one-bit flip changes the record of exactly the layer it is in
    t = torch.from_numpy(a.copy())
    t.view(torch.int32)[1, 2, 3] ^= 1
    before, after = tp.stacked_checksums(a), tp.stacked_checksums(t)
    assert [b != c for b, c in zip(before, after)] == [False, True, False]
