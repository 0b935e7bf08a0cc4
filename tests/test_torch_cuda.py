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
