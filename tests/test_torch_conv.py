"""Port parity for the conv2d slice: ``conv_same_pads``, ``im2col``, every
``pcilt_conv2d`` path and the conv / host-packed kernel wrappers of the
port against the JAX package (Pallas kernels in interpret mode on the CPU),
on seeded numpy inputs with JAX-built tables carried across the bridge.

On CPU tensors the port's wrappers run their plain versions, so these
tests hold the formula each CUDA kernel implements to the reference; the
kernels are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: on an exact grid (small-integer weights, power-of-two scale)
every sum is exact, so outputs are bit-equal.  Otherwise a conv sums up to
G = 27 float32 rows in another order than the reference's one-hot
contraction: allclose at 1e-5.  bfloat16 tables round that float32 sum
once, so they may differ by one bf16 step (1e-2).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import lut_layers as jl
from repro.core import offsets as jo
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.kernels import autotune as atn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import lut_layers as tl
from repro_torch.core import quantization as tq
from repro_torch.interop import tables_from_jax, to_torch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _compare(got, want, dtype, exact):
    got, want = got.float().numpy(), _np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,kh,kw,stride", [
    (7, 6, 3, 3, 1), (8, 8, 5, 5, 2), (7, 9, 3, 5, 2), (1024, 768, 5, 5, 1),
    (5, 4, 4, 2, 3), (2, 2, 5, 5, 1)])
def test_conv_same_pads_match_reference(h, w, kh, kw, stride):
    assert tl.conv_same_pads(h, w, kh, kw, stride) == \
        jl.conv_same_pads(h, w, kh, kw, stride)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
def test_im2col_matches_reference(stride, padding):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 7, 6, 3)).astype(np.float32)
    want = jl.im2col(jnp.asarray(x), 3, 2, stride, padding)
    got = tl.im2col(torch.from_numpy(x), 3, 2, stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# B, H, W, C, O, k, stride, bits, symmetric, group, table dtype, exact grid
CASES = [
    (2, 6, 5, 3, 5, 3, 1, 4, True, 1, "float32", False),
    (1, 6, 7, 3, 13, 3, 2, 2, False, 2, "float32", False),  # n 27, pad 1
    (2, 5, 5, 1, 7, 3, 1, 4, True, 2, "bfloat16", False),   # C 1: segments cross taps
    (1, 5, 6, 3, 9, 3, 1, 3, True, 2, "float32", True),
]
IDS = ["sym4-g1", "asym2-g2-s2", "sym4-g2-C1-bf16", "exact-g2"]


def _case(B, H, W, C, O, k, bits, sym, group, dtype, exact, seed):
    rng = np.random.default_rng(seed)
    filt = (rng.integers(-3, 4, size=(k, k, C, O)) if exact
            else rng.normal(size=(k, k, C, O))).astype(np.float32)
    x = (1.5 * rng.normal(size=(B, H, W, C))).astype(np.float32)
    scale = np.float32(0.5 if exact else 0.37)
    sj, st = jq.QuantSpec(bits, sym), tq.QuantSpec(bits, sym)
    n = k * k * C
    wflat = filt.reshape(n, O)
    pad = (-n) % group
    if pad:
        wflat = np.concatenate([wflat, np.zeros((pad, O), np.float32)])
    dense = jp.build_grouped_tables(jnp.asarray(wflat), sj, scale, group)
    dense = dense.astype(jnp.dtype(dtype))
    shared = jp.build_shared_grouped_tables(jnp.asarray(wflat), sj, scale,
                                            group)
    shared = jp.SharedGroupedTables(pool=shared.pool.astype(jnp.dtype(dtype)),
                                    seg_idx=shared.seg_idx, group=group)
    return filt, x, scale, sj, st, dense, shared


@pytest.mark.parametrize("B,H,W,C,O,k,stride,bits,sym,group,dtype,exact",
                         CASES, ids=IDS)
def test_conv_offsets_match_reference(B, H, W, C, O, k, stride, bits, sym,
                                      group, dtype, exact):
    """``conv_offsets`` against the reference's chain: im2col, quantize,
    code 0 in the group-alignment slots (the fused conv kernel's
    convention), pack."""
    _, x, scale, sj, st, _, _ = _case(B, H, W, C, O, k, bits, sym, group,
                                      dtype, exact, seed=B * 3 + C + O)
    codes = jq.quantize(jl.im2col(jnp.asarray(x), k, k, stride, "SAME"), sj,
                        scale)
    pad = (-codes.shape[-1]) % group
    codes = jnp.pad(codes, ((0, 0),) * 3 + ((0, pad),))
    want = jo.pack_offsets(codes, bits, group)
    got = tl.conv_offsets(torch.from_numpy(x), st, float(scale), group, k, k,
                          stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("path", ["gather", "onehot", "kernel", "fused",
                                  "shared"])
@pytest.mark.parametrize("B,H,W,C,O,k,stride,bits,sym,group,dtype,exact",
                         CASES, ids=IDS)
def test_pcilt_conv2d_paths_match_reference(B, H, W, C, O, k, stride, bits,
                                            sym, group, dtype, exact, path):
    filt, x, scale, sj, st, dense, shared = _case(
        B, H, W, C, O, k, bits, sym, group, dtype, exact, seed=B * 7 + C + O)
    jt = shared if path == "shared" else dense
    want = jl.pcilt_conv2d(jnp.asarray(x), jnp.asarray(filt), sj, scale,
                           group, stride=stride, tables=jt, path=path)
    got = tl.pcilt_conv2d(torch.from_numpy(x), torch.from_numpy(filt), st,
                          float(scale), group, stride=stride,
                          tables=tables_from_jax(jt, "cpu"), path=path)
    assert got.shape == tuple(want.shape)
    _compare(got, want, dtype, exact)


@pytest.mark.parametrize("B,H,W,C,O,k,stride,bits,sym,group,dtype,exact",
                         CASES, ids=IDS)
def test_conv_kernel_wrappers_match_reference(B, H, W, C, O, k, stride, bits,
                                              sym, group, dtype, exact):
    """``ops.pcilt_{fused,shared}_conv2d`` (plain versions) against the JAX
    ``ops`` functions.  The shared pool's pointers run in reverse, so the
    segment that holds the group-alignment slot reads a table whose slot
    weight is not zero (the slot's code, 0, shows), and one pointer is out
    of range, which adds nothing on both sides."""
    filt, x, scale, sj, st, dense, shared = _case(
        B, H, W, C, O, k, bits, sym, group, dtype, exact, seed=B + C * 5 + O)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = jops.pcilt_fused_conv2d(xj, dense, sj, scale, group, k, k,
                                   stride=stride)
    got = tops.pcilt_fused_conv2d(xt, to_torch(dense), st, float(scale),
                                  group, k, k, stride=stride)
    _compare(got, want, dtype, exact)
    idx = np.asarray(shared.seg_idx, np.int32)[::-1].copy()
    idx[len(idx) // 2] = shared.pool.shape[0] + 3  # a pointer out of range
    want = jops.pcilt_shared_conv2d(xj, shared.pool, jnp.asarray(idx), sj,
                                    scale, group, k, k, stride=stride)
    got = tops.pcilt_shared_conv2d(xt, to_torch(shared.pool),
                                   torch.from_numpy(idx), st, float(scale),
                                   group, k, k, stride=stride)
    _compare(got, want, dtype, exact)
    assert all(v == 0 for v in tops.LAUNCHES.values())


@pytest.mark.parametrize("dtype,exact", [("float32", False),
                                         ("bfloat16", False),
                                         ("float32", True)])
def test_host_packed_wrappers_match_reference(dtype, exact):
    """``ops.pcilt_gemv`` and ``ops.pcilt_conv2d`` on host-packed offsets
    against the JAX kernels and both packages' ``ref`` oracles."""
    rng = np.random.default_rng(5 + exact)
    G, V, O = 7, 16, 37
    tabs = (rng.integers(-3, 4, size=(G, V, O)) if exact
            else rng.normal(size=(G, V, O))).astype(np.float32)
    tabs = jnp.asarray(tabs).astype(jnp.dtype(dtype))
    off = rng.integers(0, V, size=(2, 5, 3, G)).astype(np.int32)
    flat = off.reshape(-1, G)
    tt = to_torch(tabs)
    _compare(tops.pcilt_gemv(torch.from_numpy(flat), tt),
             jops.pcilt_gemv(jnp.asarray(flat), tabs), dtype, exact)
    _compare(tref.pcilt_gemv_ref(torch.from_numpy(flat), tt),
             jref.pcilt_gemv_ref(jnp.asarray(flat), tabs), dtype, exact)
    _compare(tops.pcilt_conv2d(torch.from_numpy(off), tt),
             jops.pcilt_conv2d(jnp.asarray(off), tabs), dtype, exact)
    _compare(tref.pcilt_conv2d_ref(torch.from_numpy(off), tt),
             jref.pcilt_conv2d_ref(jnp.asarray(off), tabs), dtype, exact)


def test_plain_versions_work_in_chunks(monkeypatch):
    """The plain versions gather a bounded number of cells at a time; the
    result does not depend on the chunk."""
    _, x, scale, _, st, dense, _ = _case(2, 6, 5, 3, 5, 3, 4, True, 1,
                                         "float32", False, seed=9)
    xt, tt = torch.from_numpy(x), to_torch(dense)
    whole = tops.pcilt_fused_conv2d(xt, tt, st, float(scale), 1, 3, 3)
    monkeypatch.setattr(tref, "PLAIN_CHUNK_ELEMS", 7)
    chunked = tops.pcilt_fused_conv2d(xt, tt, st, float(scale), 1, 3, 3)
    assert torch.equal(whole, chunked)


def test_conv_wrappers_reject_bad_operands():
    spec = tq.QuantSpec(4, True)
    x = torch.zeros(1, 5, 5, 3)
    with pytest.raises(ValueError, match="cover"):  # G*group < kh*kw*C
        tops.pcilt_fused_conv2d(x, torch.zeros(20, 16, 4), spec, 1.0, 1, 3, 3)
    with pytest.raises(ValueError, match="2\\*\\*"):
        tops.pcilt_fused_conv2d(x, torch.zeros(27, 8, 4), spec, 1.0, 1, 3, 3)
    with pytest.raises(ValueError, match="padding"):
        tops.pcilt_fused_conv2d(x, torch.zeros(27, 16, 4), spec, 1.0, 1, 3,
                                3, padding="FULL")
    with pytest.raises(TypeError):
        tops.pcilt_shared_conv2d(x, torch.zeros(2, 16, 4),
                                 torch.zeros(27, dtype=torch.int64), spec,
                                 1.0, 1, 3, 3)
    with pytest.raises(TypeError):
        tops.pcilt_gemv(torch.zeros(2, 3), torch.zeros(3, 16, 4))
    with pytest.raises(ValueError):
        tops.pcilt_conv2d(torch.zeros(2, 3, dtype=torch.int32),
                          torch.zeros(3, 16, 4))
    with pytest.raises(ValueError, match="contiguous segments"):
        tl.pcilt_conv2d(x, torch.zeros(3, 3, 3, 4), spec, 1.0, 1,
                        tables=torch.zeros(30, 16, 4), path="fused")


class _FakeConvLibrary:
    """Stands in for the conv library: answers the staged tiling from the
    mirror and records each call's entry point and arguments."""

    def __init__(self):
        self.calls = []

    def pcilt_conv2d_staged_config(self, cfg):
        cfg[:] = [tops.STAGED_PIX_TILE, tops.STAGED_COL_TILE,
                  tops.STAGED_STAGES, tops.STAGED_OFF_RING,
                  tops.STAGED_ROW_PITCH, tops.STAGED_MAX_V]
        return 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def test_a_batch_past_the_grid_reaches_the_conv_library(monkeypatch):
    """65,537 images, past the 65535 a grid's z dimension holds: the code
    pre-pass walks its images, so the staged conv passes the whole batch
    to both of its launches (the pre-pass and the fetch), as the
    reference's kernel takes any batch."""
    from repro_torch.kernels import build

    lib = _FakeConvLibrary()
    monkeypatch.setattr(tops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(tops, "_call", lambda name, fn, x, *args: fn(*args))
    monkeypatch.setattr(tops, "_STAGED_CHECKED", [])
    monkeypatch.setattr(tops, "LAUNCHES", dict.fromkeys(tops.LAUNCHES, 0))
    monkeypatch.setattr(tops, "CONV_VARIANT_LAUNCHES",
                        {"staged": 0, "direct": 0})
    B, C, O = 65537, 4, 8
    spec = tq.QuantSpec(8, True)
    x = torch.zeros(B, 2, 2, C)
    out = tops._fused_conv2d(x, torch.zeros(9 * C, 256, O), spec, 0.5, 1, 3,
                             3, variant="staged")
    assert out.shape == (B, 2, 2, O)
    (codes, cargs), (fetch, fargs) = lib.calls
    assert codes == "pcilt_conv2d_codes_f32" and cargs[2:6] == (B, 4, 4, C)
    assert fetch == "pcilt_fused_conv2d_staged_f32" and fargs[4] == B
    assert tops.LAUNCHES["fused_conv2d"] == 1
    assert tops.CONV_VARIANT_LAUNCHES == {"staged": 1, "direct": 0}
