"""Port parity of the optimizer: the six cases of ``tests/test_optim.py``,
each also against the JAX function.

Where both packages take one gradient tree (the JAX one, carried across),
the updated parameters and moments agree to float32 rounding (1e-6).  The
int8 moments' codes are equal except where the quotient ``m / scale`` sits
at an exact half (a rounding tie, where a float32 ulp of difference in
``m`` picks the other neighbour): those are counted and must be few and
one code apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import adamw as ja
from repro_torch.interop import to_torch
from repro_torch.optim import adamw as ta


def _target():
    return {"w": np.asarray([[1.0, -2.0], [3.0, 0.5]], np.float32),
            "b": np.asarray([0.3, -0.7], np.float32)}


def _jloss(p, target):
    return sum(jnp.sum((p[k] - target[k]) ** 2) for k in target)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return to_torch(np.asarray(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tie_ok(q_t, q_j, m_f, scale):
    """Codes equal, or one apart where ``m_f / scale`` is a rounding tie
    (within 4 ulps of a half); returns the number of ties taken."""
    diff = np.abs(q_t.astype(np.int32) - q_j.astype(np.int32))
    assert diff.max(initial=0) <= 1
    r = (m_f / scale).astype(np.float32)
    frac = np.abs(r - np.trunc(r))
    ulp = np.spacing(np.abs(r).astype(np.float32))
    tie = np.abs(frac - np.float32(0.5)) <= 4 * ulp
    assert not (diff.astype(bool) & ~tie).any(), "a code differs off a tie"
    return int(diff.sum())


def _trajectory(quantized: bool, steps=300):
    """The reference's loop on the quadratic problem; at every step the
    port's ``adamw_update`` takes the same gradient, state and parameters.
    Returns the final loss and the number of tie codes."""
    target = {k: jnp.asarray(v) for k, v in _target().items()}
    cfg_j = ja.AdamWConfig(lr=0.05, weight_decay=0.0,
                           quantize_moments=quantized)
    cfg_t = ta.AdamWConfig(lr=0.05, weight_decay=0.0,
                           quantize_moments=quantized)
    params = jax.tree.map(jnp.zeros_like, target)
    state = ja.adamw_init(params, cfg_j)
    ties = 0
    for _ in range(steps):
        g = jax.grad(_jloss)(params, target)
        new_p, new_s, m = ja.adamw_update(g, state, params, cfg_j)
        got_p, got_s, gm = ta.adamw_update(_t(g), _t(state), _t(params),
                                           cfg_t)
        for k in ("w", "b"):
            np.testing.assert_allclose(got_p[k].numpy(), np.asarray(new_p[k]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(gm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-6)
        assert int(got_s["count"]) == int(new_s["count"])
        if quantized:
            gc, _ = ja.clip_by_global_norm(g, cfg_j.clip_norm)
            for mom, b in (("m", cfg_j.b1), ("v", cfg_j.b2)):
                for k in ("w", "b"):
                    old = state[mom][k]
                    dq = np.asarray(ja._dq8(old["q"], old["scale"]))
                    gk = np.asarray(gc[k])
                    new = (np.float32(b) * dq + np.float32(1 - b) *
                           (gk if mom == "m" else gk * gk))
                    want, got = new_s[mom][k], got_s[mom][k]
                    np.testing.assert_allclose(got["scale"].numpy(),
                                               np.asarray(want["scale"]),
                                               rtol=1e-6)
                    ties += _tie_ok(got["q"].numpy(), np.asarray(want["q"]),
                                    new, np.asarray(want["scale"]))
        else:
            for mom in ("m", "v"):
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        got_s[mom][k].numpy(), np.asarray(new_s[mom][k]),
                        rtol=1e-6, atol=1e-12)
        params, state = new_p, new_s
    return float(_jloss(params, target)), ties


def _port_loop(cfg, steps=300):
    """The port's own loop (its own gradients, from autograd)."""
    target = {k: torch.from_numpy(v) for k, v in _target().items()}
    params = {k: torch.zeros_like(v) for k, v in target.items()}
    state = ta.adamw_init(params, cfg)
    for _ in range(steps):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = sum(((leaves[k] - target[k]) ** 2).sum() for k in target)
        g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, state, _ = ta.adamw_update(g, state, params, cfg)
    return float(sum(((params[k] - target[k]) ** 2).sum() for k in target))


def test_adamw_converges():
    final, _ = _trajectory(quantized=False)
    assert final < 1e-3
    assert _port_loop(ta.AdamWConfig(lr=0.05, weight_decay=0.0)) < 1e-3


def test_adamw_int8_moments_converge():
    final, ties = _trajectory(quantized=True)
    assert final < 5e-3
    assert ties <= 12  # of 300 steps x 12 codes
    assert _port_loop(ta.AdamWConfig(lr=0.05, weight_decay=0.0,
                                     quantize_moments=True)) < 5e-3


def test_int8_state_shapes_match_reference():
    shapes = {"w": (8, 256), "b": (16,), "t": (3, 4, 5)}
    cfg_j = ja.AdamWConfig(quantize_moments=True)
    cfg_t = ta.AdamWConfig(quantize_moments=True)
    st_j = ja.adamw_init({k: jnp.zeros(s) for k, s in shapes.items()}, cfg_j)
    st_t = ta.adamw_init({k: torch.zeros(s) for k, s in shapes.items()},
                         cfg_t)
    assert st_t["m"]["w"]["q"].dtype == torch.int8
    assert tuple(st_t["m"]["w"]["q"].shape) == (8, 256)
    assert tuple(st_t["m"]["w"]["scale"].shape) == (8, 1)
    assert st_t["count"].dtype == torch.int32 and st_t["count"].dim() == 0
    fj, ft = _flat(_np(st_j)), _flat(_np(st_t))
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert ft[k].shape == fj[k].shape and ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k])
    for quantized in (False, True):
        st = ta.adamw_init({"w": torch.zeros(2, 3)},
                           ta.AdamWConfig(quantize_moments=quantized))
        assert set(st) == {"count", "m", "v"}


def test_q8_matches_reference_at_ties():
    """A true division and round-half-even: a row whose scale is exactly
    1.0 puts its halves on ties, which both round to the even code."""
    x = np.asarray([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0],
                    [3.0, -1.0, 0.25, 0.0, 7.0, -2.0]], np.float32)
    qj, sj = ja._q8(jnp.asarray(x))
    qt, st = ta._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.numpy()[0], [0, 2, 2, 0, -2, 127])
    np.testing.assert_array_equal(
        ta._dq8(qt, st).numpy(), np.asarray(ja._dq8(qj, sj)))


def test_cosine_schedule_shape():
    lr_t = ta.cosine_schedule(1.0, warmup=10, total=100, floor=0.1)
    lr_j = ja.cosine_schedule(1.0, warmup=10, total=100, floor=0.1)
    assert float(lr_t(torch.tensor(0))) == 0.0
    assert abs(float(lr_t(torch.tensor(10))) - 1.0) < 1e-6
    assert float(lr_t(torch.tensor(55))) < 1.0
    assert abs(float(lr_t(torch.tensor(100))) - 0.1) < 1e-2
    for s in range(0, 120, 3):
        np.testing.assert_allclose(
            float(lr_t(torch.tensor(s, dtype=torch.int32))),
            float(lr_j(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-7)


def test_clipping():
    tree = {"a": np.ones((4,), np.float32) * 10.0,
            "b": {"c": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    got, n = ta.clip_by_global_norm(_t(tree), 1.0)
    want, nj = ja.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    assert abs(float(ta.global_norm(got)) - 1.0) < 1e-5
    assert float(n) > 1.0
    np.testing.assert_allclose(float(n), float(nj), rtol=1e-6)
    for k, v in _flat(_np(want)).items():
        np.testing.assert_allclose(_flat(_np(got))[k], v, rtol=1e-6)
    small, _ = ta.clip_by_global_norm({"a": torch.full((2,), 0.1)}, 1.0)
    torch.testing.assert_close(small["a"], torch.full((2,), 0.1))


def test_weight_decay_only_matrices():
    """Norms and biases (fewer than 2 dimensions) skip decay."""
    params = {"w": np.ones((2, 2), np.float32), "b": np.ones((2,), np.float32)}
    cfg_j = ja.AdamWConfig(lr=0.1, weight_decay=1.0)
    cfg_t = ta.AdamWConfig(lr=0.1, weight_decay=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    want, _, _ = ja.adamw_update(jax.tree.map(jnp.zeros_like, jp),
                                 ja.adamw_init(jp, cfg_j), jp, cfg_j)
    tp = _t(params)
    zero = {k: torch.zeros_like(v) for k, v in tp.items()}
    got, _, _ = ta.adamw_update(zero, ta.adamw_init(tp, cfg_t), tp, cfg_t)
    assert float((got["w"] - 1.0).abs().max()) > 1e-3  # decayed
    assert float((got["b"] - 1.0).abs().max()) < 1e-6  # untouched
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    # the arguments are left as they were
    torch.testing.assert_close(tp["w"], torch.ones(2, 2))
