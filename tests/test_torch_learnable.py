"""Port parity: extension 4, learnable tables ("Using PCILTs as Weights").

Parameters are drawn by the JAX package (``init_learnable_pcilt``) and
carried across by ``interop.learnable_from_jax``; inputs come from numpy
seeds.  Each granularity's forward, its gradients against ``jax.grad`` and
three SGD steps agree within rtol = atol = 1e-5 (float32 sums and
scatter-adds in another order).  ``extract_filters`` agrees within 1e-4
(two pseudo-inverses by SVD) and recovers product-built filters within
1e-4.  ``path="kernel"`` refuses tables that require grad and serves them,
under ``torch.no_grad()``, equal to the gather path within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import learnable as jlearn
from repro.core import quantization as jq
from repro_torch.core import learnable as tlearn
from repro_torch.core import quantization as tq
from repro_torch.interop import learnable_from_jax, to_torch
from repro_torch.launch import learnable_pcilt

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(gran, n_in=7, n_out=3, batch=6, seed=0):
    """JAX-initialised parameters (a non-trivial adjustment added, so every
    factor matters) and seeded data; ``n_in`` odd: one alignment slot."""
    rng = np.random.default_rng(seed)
    jspec, tspec = jq.QuantSpec(2), tq.QuantSpec(2)
    x = rng.uniform(0, 2, size=(batch, n_in)).astype(np.float32)
    y = rng.normal(size=(batch, n_out)).astype(np.float32)
    scale = 0.6
    p = jlearn.init_learnable_pcilt(jax.random.PRNGKey(seed), n_in, n_out,
                                    jspec, scale, 2, granularity=gran)
    p = {k: np.asarray(v) + (0.0 if k == "base" else
                             0.1 * rng.normal(size=v.shape)
                             .astype(np.float32))
         for k, v in p.items()}
    return jspec, tspec, x, y, scale, p


def _jax_loss(p, x, y, spec, scale, path="gather"):
    pred = jlearn.apply_learnable_pcilt(p, x, spec, scale, 2, path=path)
    return jnp.mean((pred - y) ** 2)


def _torch_loss(p, x, y, spec, scale, path="gather"):
    pred = tlearn.apply_learnable_pcilt(p, x, spec, scale, 2, path=path)
    return torch.mean((pred - y) ** 2)


@pytest.mark.parametrize("path", ["gather", "onehot"])
@pytest.mark.parametrize("gran", tlearn.GRANULARITIES)
def test_forward_grads_and_sgd_match_jax(gran, path):
    jspec, tspec, x, y, scale, p = _case(gran)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    tparams = learnable_from_jax(p, "cpu")
    assert all(v.requires_grad for v in tparams.values())
    np.testing.assert_allclose(
        tlearn.apply_learnable_pcilt(tparams, tx, tspec, scale, 2,
                                     path=path).detach().numpy(),
        np.asarray(jlearn.apply_learnable_pcilt(jparams, jx, jspec, scale, 2,
                                                path=path)), **TOL)
    for _ in range(3):
        jg = jax.grad(_jax_loss)(jparams, jx, jy, jspec, scale, path)
        names = list(tparams)
        tg = torch.autograd.grad(_torch_loss(tparams, tx, ty, tspec, scale,
                                             path),
                                 [tparams[k] for k in names])
        for k, g in zip(names, tg):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **TOL)
        jparams = jax.tree.map(lambda a, b: a - 0.05 * b, jparams, jg)
        with torch.no_grad():
            for k, g in zip(names, tg):
                tparams[k] -= 0.05 * g
    for k in tparams:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), **TOL)


@pytest.mark.parametrize("gran", tlearn.GRANULARITIES)
def test_init_matches_reference_from_base_weights(gran):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(7, 3)).astype(np.float32)
    want = jlearn.init_learnable_pcilt(jax.random.PRNGKey(0), 7, 3,
                                       jq.QuantSpec(2), 0.6, 2,
                                       granularity=gran,
                                       base_weights=jnp.asarray(w))
    got = tlearn.init_learnable_pcilt(None, 7, 3, tq.QuantSpec(2), 0.6, 2,
                                      granularity=gran,
                                      base_weights=torch.from_numpy(w))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].requires_grad and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    drawn = tlearn.init_learnable_pcilt(torch.Generator().manual_seed(0), 7,
                                        3, tq.QuantSpec(2), 0.6, 2,
                                        granularity=gran)
    assert drawn["base"].shape == want["base"].shape
    with pytest.raises(ValueError):
        tlearn.init_learnable_pcilt(None, 7, 3, tq.QuantSpec(2), 0.6, 2,
                                    granularity="weights")


def test_extract_filters_matches_reference_and_recovers_weights():
    rng = np.random.default_rng(2)
    jspec, tspec = jq.QuantSpec(2), tq.QuantSpec(2)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    p = jlearn.init_learnable_pcilt(jax.random.PRNGKey(0), 8, 5, jspec, 0.5,
                                    2, base_weights=jnp.asarray(w))
    tables = np.asarray(p["base"]) + 0.01 * rng.normal(
        size=p["base"].shape).astype(np.float32)
    want = np.asarray(jlearn.extract_filters(jnp.asarray(tables), jspec, 0.5,
                                             2))
    got = tlearn.extract_filters(torch.from_numpy(tables), tspec, 0.5, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    back = tlearn.extract_filters(to_torch(p["base"]), tspec, 0.5, 2)
    np.testing.assert_allclose(back.numpy(), w, rtol=1e-4, atol=1e-4)


def test_kernel_path_refuses_tables_that_require_grad():
    _, tspec, x, _, scale, p = _case("entry")
    params = learnable_from_jax(p, "cpu")
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="'gather' or\\s+'onehot'"):
        tlearn.apply_learnable_pcilt(params, tx, tspec, scale, 2,
                                     path="kernel")
    with torch.no_grad():
        served = tlearn.apply_learnable_pcilt(params, tx, tspec, scale, 2,
                                              path="kernel")
        trained = tlearn.apply_learnable_pcilt(params, tx, tspec, scale, 2)
    np.testing.assert_allclose(served.numpy(), trained.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_learnable_entry_point_trains_on_cpu():
    lines = []
    out = learnable_pcilt.run(device="cpu", log=lines.append)
    assert set(out["losses"]) == set(tlearn.GRANULARITIES)
    for gran, (l0, l1) in out["losses"].items():
        assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0, (gran, l0, l1)
        assert out["kernel_max_abs_err"][gran] <= 1e-5
    assert np.isfinite(out["filter_mse"])
    assert any("filters rebuilt" in line for line in lines)
