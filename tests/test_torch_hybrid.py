"""Port parity of the hybrid family (``repro_torch.models.hybrid``) at the
zamba2-7b smoke config (7 Mamba2 blocks in segments of 3, so 3 shared
attention applications over 2 parameter sets), against
``repro.models.hybrid``.

Tolerances, those of the Mamba family's parity tests: float32 compute
1e-5 for the loss and its metrics; 2e-2 of the largest entry for the
gradients, the prefill logits and the prefill's SSM states (the SSD keeps
its O(T) operands in bfloat16 in both packages, summed in other orders);
1e-4 for a decode step's logits from the reference's cache (the step reads
the bfloat16 KV cache); bfloat16 compute 2e-2 for the loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.nn.layers import Ctx
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_torch, tree_leaves
from repro_torch.launch import serve as ts
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import HybridLM, build_model
from test_torch_donor import jax_donor

CTX = Ctx()
ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dt="f32", **kw):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(j_smoke(ARCH), dtype=jd, **kw),
            dataclasses.replace(t_smoke(ARCH), dtype=td, **kw))


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def donor():
    return jax.tree.map(np.asarray, jax_donor(
        j_build(_cfgs()[0]).param_specs(), 0))


def test_config_and_structure_match_reference():
    for get_j, get_t in ((j_full, t_full), (j_smoke, t_smoke)):
        j, t = get_j(ARCH), get_t(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim",
                  "shared_attn_period", "n_shared_attn_blocks",
                  "remat_policy", "loss_chunk"):
            assert getattr(t, f) == getattr(j, f), f
        for f in dataclasses.fields(j.ssm):
            if f.name != "dt_rank":
                assert getattr(t.ssm, f.name) == getattr(j.ssm, f.name)
        jm, tm = j_build(j), build_model(t)
        assert isinstance(tm, HybridLM)
        assert tm._segments() == jm._segments()
        assert tm.n_attn_applications() == jm.n_attn_applications()
    assert build_model(t_full(ARCH)).n_attn_applications() == 14
    jcfg, tcfg = _cfgs()
    shapes = {k: tuple(v.shape) for k, v in _flat(
        build_model(tcfg).param_specs()).items()}
    want = {k: tuple(v.shape) for k, v in _flat(
        j_build(jcfg).param_specs()).items()}
    assert shapes == want
    tc = build_model(tcfg).cache_specs(2, 16)
    jc = j_build(jcfg).cache_specs(2, 16)
    assert {k: tuple(v.shape) for k, v in _flat(tc).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jc).items()}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(dt, donor):
    jcfg, tcfg = _cfgs(dt)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 32)),
             "labels": rng.integers(0, jcfg.vocab, (2, 32))}
    jm = j_build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, CTX), has_aux=True)(
        jax.tree.map(jnp.asarray, donor))
    tp = params_from_jax(donor, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, tmet = build_model(tcfg).loss(tp, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol)
    for n in ("ce", "z"):
        np.testing.assert_allclose(float(tmet[n].detach()), float(jmet[n]),
                                   rtol=tol)
    if dt == "bf16":
        return
    tg = dict(zip(_flat(tp), torch.autograd.grad(tl, leaves)))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    for k, want in jflat.items():
        _close(tg[k], want, 2e-2)
    # both shared parameter sets take gradients (applications 0, 2 and 1)
    for k in tg:
        if k.startswith("/shared/attn/wq/kernel"):
            assert bool((tg[k].abs().sum((1, 2, 3)) > 0).all())


def test_loss_does_not_depend_on_the_remat_policy(donor):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    b = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 16))),
         "labels": torch.from_numpy(rng.integers(0, 256, (2, 16)))}
    out = []
    for policy in ("none", "full", "dots"):
        tp = params_from_jax(donor, "cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        loss, _ = build_model(dataclasses.replace(
            tcfg, remat_policy=policy)).loss(tp, b)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, g0 in zip(grads, out[0][1]):
            assert torch.equal(g, g0)


def _port_cache(jc):
    return {"ssm": {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                           jc["ssm"]["layers"])},
            "attn": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                 jc["attn"]),
            "pos": int(jc["pos"])}


def test_prefill_and_decode_match_reference(donor):
    """A 12-token prompt at B = 2, then five decode steps.  Each port step
    starts from the reference's cache (a bfloat16 KV entry can round the
    other way at a tie); the caches the steps write — the segment scatter
    of the SSM states and each application's KV — are held to the
    reference's."""
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    jp = jax.tree.map(jnp.asarray, donor)
    tp = params_from_jax(donor, "cpu")
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 12))
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, {"tokens":
                                               torch.from_numpy(tokens)})
    _close(tl_, jl_, 2e-2)
    assert tc["pos"] == int(jc["pos"]) == 12
    step = make_decode_step(tcfg)
    for i in range(5):
        for n in ("conv", "ssd"):
            _close(tc["ssm"]["layers"][n], jc["ssm"]["layers"][n],
                   2e-2 if i == 0 else 1e-4)
        for n in ("k", "v"):
            assert tuple(tc["attn"][n].shape) == tuple(jc["attn"][n].shape)
            _close(tc["attn"][n], jc["attn"][n], 2 ** -7)
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
        jin = jc
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, _port_cache(jin), torch.from_numpy(tok))
        _close(tl_[:, :jcfg.vocab], jl_[:, :jcfg.vocab], 1e-4)
    assert tc["pos"] == int(jc["pos"]) == 17


def test_decode_replays_the_prefill(donor):
    """The port's own prefill of a prompt against the port's decode steps
    over the same prompt from an empty cache (the check ``chip_smoke.py``
    makes at full width): the last logits within 2e-2 of the largest."""
    _, tcfg = _cfgs()
    m = build_model(tcfg)
    tp = params_from_jax(donor, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256,
                                                                (2, 9)))
    with torch.no_grad():
        want, _ = m.prefill(tp, {"tokens": tokens})
        from repro_torch.nn.module import materialize
        cache = materialize(m.cache_specs(2, 16), 0, device="cpu")
        cache["pos"] = 0
        for t in range(9):
            got, cache = m.decode_step(tp, cache, tokens[:, t:t + 1])
    _close(got, want, 2e-2)
    assert cache["pos"] == 9


def test_engine_refuses_the_hybrid_family():
    """The reference's Engine fails at its first slot reset (its
    ``_reset_slot`` reads ``cache["layers"]``); the port refuses at
    construction and names that."""
    with pytest.raises(NotImplementedError, match="_reset_slot"):
        ts.Engine(t_smoke(ARCH), 64, 2, device="cpu")


def test_trainer_takes_the_smoke_config(tmp_path):
    from repro_torch.launch import train as ttrain

    out = ttrain.main(["--arch", ARCH, "--steps", "3", "--seq", "16",
                       "--batch", "2", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    assert out["step"] == 3 and all(np.isfinite(out["losses"]))
