"""Port parity of training at the smoke configs: the chunked vocabulary
loss, both LM families' ``loss`` and its gradients, ``make_train_step``
(``bf16_grads``, ``grad_accum``), and the training entry points.

The JAX package's parameters cross the numpy bridge; the JAX losses run
under ``jax.jit`` (its CPU backend needs that for the SSD's bfloat16
contractions).  Tolerances:

* ``chunked_ce_loss``: 1e-6 (float32 sums in another order);
* ``loss``: loss, ce and z to 1e-5 at float32 compute, 2e-2 at bfloat16;
  the gradients at float32 compute within 1e-5 of each leaf's largest
  gradient (dense), within 2e-2 of it for Mamba (its SSD rounds its O(T)
  operands to bfloat16 in both packages, and values that agree to ~1e-7
  round to neighbouring bfloat16 values now and then; the gradients of
  ``A_log`` and ``dt_bias`` sum over every such operand);
* ``make_train_step`` casts the float32 masters to bfloat16 before use
  whatever ``cfg.dtype`` is, and the cast's cotangent is bfloat16 (as
  JAX's ``astype`` transposes), so the gradients of those leaves are
  bfloat16 values with or without ``bf16_grads``.  At float32 compute the
  loss, ce and z agree to 1e-5, the 1-D leaves' gradients within 1e-5 of
  each leaf's largest, the cast leaves' and the global norm within one
  bfloat16 step (2**-7).  AdamW's
  first update is ``~sign(g)``,
  so one gradient element of another sign moves a parameter by 2 lr: the
  updated parameters are compared where the gradients are shared (the
  port's ``adamw_update`` on the JAX gradients), and the port's step is
  checked to be its own gradients through that update.  The gradients of
  a step are read off a probe optimizer (``b1 = 0``, no clipping, zero
  moments), whose first moment after one update is the gradient itself.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as jsteps
from repro.models import build_model as j_build
from repro.models.transformer import chunked_ce_loss as j_ce
from repro.nn.layers import Ctx
from repro.optim import adamw as jopt
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data import SyntheticLM
from repro_torch.interop import params_from_jax, tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train, train_lm
from repro_torch.models import build_model as t_build
from repro_torch.models.transformer import chunked_ce_loss as t_ce
from repro_torch.optim import adamw as topt
from test_torch_donor import jax_donor

CTX = Ctx()
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ["qwen3-0.6b", "qwen1.5-4b", "mamba2-130m"]


def _cfgs(arch, dt="f32", **kw):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(j_smoke(arch), dtype=jd, **kw),
            dataclasses.replace(t_smoke(arch), dtype=td, **kw))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _batch(cfg, seed=0, B=4, S=32, step=0):
    return SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       seed=seed).batch(step)


@pytest.fixture(scope="module")
def donors():
    """Each arch's JAX smoke parameters (float32), as numpy."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        jp = jax_donor(j_build(jcfg).param_specs(), 0)
        out[arch] = jax.tree.map(np.asarray, jp)
    return out


# -- the chunked vocabulary loss ------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4, 5, 12, 64])
@pytest.mark.parametrize("ragged", [False, True])
def test_chunked_ce_loss_matches_reference(chunk, ragged):
    """One chunk (0, 12, 64), three (4), and a chunk that steps down to a
    divisor (5 -> 4); a ragged mask and an all-zero row; values and the
    gradients of x and the head to 1e-6."""
    rng = np.random.default_rng(chunk + 10 * ragged)
    x = rng.standard_normal((3, 12, 8)).astype(np.float32)
    w = (0.5 * rng.standard_normal((8, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.float32)
    if ragged:
        mask[0, 7:] = 0.0
        mask[1] = 0.0
    jfn = lambda x, w: j_ce(lambda xc: xc @ w, x, jnp.asarray(labels),
                            jnp.asarray(mask), chunk)
    (jce, jz) = jfn(jnp.asarray(x), jnp.asarray(w))
    jg = jax.grad(lambda x, w: sum(jfn(x, w)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ce, z = t_ce(lambda xc: xc @ tw, tx, torch.from_numpy(labels),
                 torch.from_numpy(mask), chunk)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    np.testing.assert_allclose(float(z), float(jz), rtol=1e-6)
    gx, gw = torch.autograd.grad(ce + z, [tx, tw])
    for got, want in ((gx, jg[0]), (gw, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_chunked_ce_loss_empty_mask():
    """An all-zero mask divides by 1, not 0."""
    x = torch.ones(1, 4, 2)
    ce, z = t_ce(lambda xc: xc @ torch.ones(2, 3), x,
                 torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, 4), 2)
    assert float(ce) == float(z) == 0.0


# -- the models' loss ------------------------------------------------------


def _j_loss_and_grads(jcfg, params, batch):
    model = j_build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jb, CTX), has_aux=True))
    (loss, m), g = fn(jax.tree.map(jnp.asarray, params))
    return loss, m, g


def _t_loss_and_grads(tcfg, params, batch):
    model = t_build(tcfg)
    tp = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = model.loss(tp, tb)
    g = torch.autograd.grad(loss, leaves)
    names = list(_flat(tp))
    return loss, m, dict(zip(names, g))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, dt, donors):
    jcfg, tcfg = _cfgs(arch, dt)
    batch = _batch(jcfg)
    jl, jm, jg = _j_loss_and_grads(jcfg, donors[arch], batch)
    tl, tm, tg = _t_loss_and_grads(tcfg, donors[arch], batch)
    tol = 1e-5 if dt == "f32" else 2e-2
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]), (tm["z"], jm["z"])):
        np.testing.assert_allclose(float(got), float(want), rtol=tol)
    if dt == "bf16":
        return
    gtol = 2e-2 if arch == "mamba2-130m" else 1e-5
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    for k, want in jflat.items():
        want = np.asarray(want)
        got = tg[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=gtol * np.abs(want).max(),
                                   err_msg=k)


def test_mamba_gradients_stay_finite_over_a_long_chunk(donors):
    """An SSD chunk of 128 steps (mamba2-130m's config has 256): the decay
    above the diagonal, ``exp(li - lj)``, overflows float32 there.  The
    reference masks after the exp, so its gradients are NaN (inf times a
    zero cotangent); the port masks inside it.  Same loss, finite
    gradients."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=128))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             chunk=128))
    batch = _batch(jcfg, B=2, S=128)
    jl, _, jg = _j_loss_and_grads(jcfg, donors["mamba2-130m"], batch)
    tl, _, tg = _t_loss_and_grads(tcfg, donors["mamba2-130m"], batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jg))
    for k, g in tg.items():
        assert bool(torch.isfinite(g).all()), k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_loss_does_not_depend_on_the_remat_policy(arch, donors):
    """``none``, ``full`` (checkpoint per block) and ``dots`` (the
    contractions without batch dimensions kept) give the same loss and
    gradients, bit for bit; ``loss_chunk`` 8 checkpoints each CE chunk."""
    batch = _batch(j_smoke(arch))
    runs = []
    for policy in ("none", "full", "dots"):
        _, tcfg = _cfgs(arch, "bf16", remat_policy=policy, loss_chunk=8)
        runs.append(_t_loss_and_grads(tcfg, donors[arch], batch))
    for loss, m, g in runs[1:]:
        assert float(loss) == float(runs[0][0])
        for k in g:
            torch.testing.assert_close(g[k], runs[0][2][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        _, tcfg = _cfgs(arch, remat_policy="nothing")
        _t_loss_and_grads(tcfg, donors[arch], batch)


# -- the train step --------------------------------------------------------


PROBE = dict(b1=0.0, clip_norm=0.0)


def _jax_grads(jcfg, params, batch, bf16_grads):
    """The JAX step's gradients: one probe update from zero moments."""
    ocfg = jopt.AdamWConfig(lr=0.0, weight_decay=0.0, **PROBE)
    step = jax.jit(jsteps.make_train_step(jcfg, None, ocfg, bf16_grads))
    _, st, _ = step(params, jopt.adamw_init(params, ocfg), batch)
    return st["m"]


def _port_grads(tcfg, params, batch, bf16_grads):
    ocfg = topt.AdamWConfig(lr=0.0, weight_decay=0.0, **PROBE)
    step = tsteps.make_train_step(tcfg, None, ocfg, bf16_grads)
    _, st, _ = step(params, topt.adamw_init(params, ocfg), batch)
    return st["m"]


@pytest.mark.parametrize("bf16_grads,accum", [(False, 1), (True, 1),
                                              (False, 2), (True, 2)])
def test_train_step_matches_reference(bf16_grads, accum, donors):
    """Three steps of ``make_train_step`` from the JAX state of each step:
    metrics and gradients as the module says, then the update on the
    shared (JAX) gradients to 1e-6, and the port's step equal to its own
    gradients through ``adamw_update``."""
    arch = "qwen3-0.6b"
    jcfg, tcfg = _cfgs(arch, "f32", grad_accum=accum)
    ocfg_j = jopt.AdamWConfig(lr=jopt.cosine_schedule(3e-3, 2, 10),
                              weight_decay=0.01)
    ocfg_t = topt.AdamWConfig(lr=topt.cosine_schedule(3e-3, 2, 10),
                              weight_decay=0.01)
    jstep = jax.jit(jsteps.make_train_step(jcfg, None, ocfg_j, bf16_grads))
    tstep = tsteps.make_train_step(tcfg, None, ocfg_t, bf16_grads)
    jp = jax.tree.map(jnp.asarray, donors[arch])
    jo = jopt.adamw_init(jp, ocfg_j)
    data = SyntheticLM(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=3)
    for i in range(3):
        nb = data.batch(i)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        to = params_from_jax(jax.tree.map(np.asarray, jo), "cpu")
        new_jp, new_jo, jm = jstep(jp, jo, jb)
        new_tp, new_to, tm = tstep(tp, to, tb)
        assert set(tm) == {"loss", "ce", "z", "grad_norm", "lr",
                           "load_balance", "router_z"} <= set(jm)
        assert float(tm["load_balance"]) == float(jm["load_balance"]) == 0
        for k in ("loss", "ce", "z", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=2 ** -7 if k == "grad_norm"
                                       else 1e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        jg = _jax_grads(jcfg, jp, jb, bf16_grads)
        tg = _port_grads(tcfg, tp, tb, bf16_grads)
        for k, want in _flat(jg).items():
            got = _flat(tg)[k]
            tol = 2 ** -7 if got.dim() > 1 else 1e-5
            want = _np(want)
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=k)
        # the update on the shared gradients
        shared, shared_o, _ = topt.adamw_update(
            params_from_jax(jax.tree.map(np.asarray, jg), "cpu"), to, tp,
            ocfg_t)
        for k, want in _flat(new_jp).items():
            np.testing.assert_allclose(_flat(shared)[k].numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert int(new_to["count"]) == int(new_jo["count"]) == i + 1
        # the port's step is its gradients through the same update
        own, _, _ = topt.adamw_update(tg, to, tp, ocfg_t)
        for k, v in _flat(own).items():
            torch.testing.assert_close(_flat(new_tp)[k], v, rtol=0, atol=0)
        jp, jo = new_jp, new_jo


def test_train_step_leaves_its_arguments(donors):
    _, tcfg = _cfgs("qwen3-0.6b", "bf16")
    ocfg = topt.AdamWConfig()
    tp = params_from_jax(donors["qwen3-0.6b"], "cpu")
    before = {k: v.clone() for k, v in _flat(tp).items()}
    opt = topt.adamw_init(tp, ocfg)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, B=2, S=8).items()}
    new_p, new_o, _ = tsteps.make_train_step(tcfg, None, ocfg)(tp, opt,
                                                                batch)
    for k, v in _flat(tp).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
        assert not v.requires_grad
        assert not _flat(new_p)[k].requires_grad
    assert int(opt["count"]) == 0 and int(new_o["count"]) == 1


# -- the entry points ------------------------------------------------------


def _losses(out):
    return [float(l.split("loss")[1].split()[0])
            for l in out.splitlines() if l.startswith("step")]


def test_train_loop_loss_decreases(tmp_path, capsys):
    train.main(["--device", "cpu", "--arch", "qwen3-0.6b", "--steps", "30",
                "--seq", "64", "--batch", "4", "--lr", "3e-3",
                "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "5"])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) >= 4
    assert losses[-1] < losses[0] - 0.2, f"no learning: {losses}"


def test_train_loop_survives_fault_and_ends_bit_equal(tmp_path, capsys):
    """``--fail-at 15``: restored at step 10, one restart, and the final
    parameters and optimizer state of an uninterrupted run, bit for bit."""
    args = ["--device", "cpu", "--arch", "qwen2.5-3b", "--steps", "30",
            "--seq", "32", "--batch", "4", "--ckpt-every", "10",
            "--log-every", "10"]
    got = train.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                             "--fail-at", "15"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 10" in out
    assert "restarts=1" in out
    clean = train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert "restarts=0" in capsys.readouterr().out
    assert got["step"] == clean["step"] == 30
    assert len(got["losses"]) == 35 and len(clean["losses"]) == 30
    for a, b in zip(tree_leaves({"p": got["params"], "o": got["opt"]}),
                    tree_leaves({"p": clean["params"], "o": clean["opt"]})):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1"])


def test_train_lm_config_matches_the_example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_lm.py")
    spec = importlib.util.spec_from_file_location("_train_lm_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    j, t = example.config_100m(), train_lm.config_100m()
    for f in dataclasses.fields(t):
        if f.name in ("dtype", "param_dtype", "pcilt", "ssm"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    from repro.nn.module import count_params as j_count
    from repro_torch.nn.module import count_params as t_count
    assert t_count(t_build(t).param_specs()) == \
        j_count(j_build(j).param_specs())
