"""Port parity of the MoE family (``repro_torch.nn.moe`` and the MoE
``TransformerLM``) at the granite-moe-3b-a800m and llama4-maverick smoke
configs, against ``repro.nn.moe`` and ``repro.models.transformer``.

Tolerances: float32 compute 1e-5 (loss, prefill, the layer), 1e-4 for the
gradients' largest entry and the decode logits from the bfloat16 KV cache;
bfloat16 compute 2e-2 of the largest magnitude (the experts and the combine
round to bfloat16 in both packages, the products summed in other orders).

Ties in the router's top-k: the parity tests check first that no two of a
token's ``k + 1`` largest router probabilities lie within 1e-6 of each
other, so that ``jax.lax.top_k`` and ``torch.topk`` must pick the same
experts in the same order; the padded experts' probability is exactly 0
and is never picked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as js
from repro.launch.steps import active_matmul_params as j_active
from repro.models import build_model as j_build
from repro.nn import moe as jmoe
from repro.nn.layers import Ctx
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_torch, tree_leaves
from repro_torch.launch import serve as ts
from repro_torch.launch.steps import active_matmul_params as t_active
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model as t_build
from repro_torch.nn import moe as tmoe
from test_torch_donor import hash_free_engines, jax_donor

CTX = Ctx()
ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dt="f32"):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(j_smoke(arch), dtype=jd),
            dataclasses.replace(t_smoke(arch), dtype=td))


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


@pytest.fixture(scope="module")
def donors():
    return {a: jax.tree.map(np.asarray, jax_donor(
        j_build(_cfgs(a)[0]).param_specs(), 0)) for a in ARCHS}


def _moe_layer(params, arch):
    """The first MoE block's ``moe`` parameters (the unit's last block)."""
    cfg = j_smoke(arch)
    sub = f"sub{cfg.moe.interleave - 1}"
    return jax.tree.map(lambda a: a[0], params["blocks"][sub]["moe"])


def _tokens(arch, t, seed=3):
    d = j_smoke(arch).d_model
    return np.random.default_rng(seed).standard_normal((t, d)) \
        .astype(np.float32)


def _no_near_ties(probs_full, k):
    top = np.sort(probs_full, -1)[:, ::-1][:, :k + 1]
    gaps = np.abs(np.diff(top, axis=-1))
    assert (gaps > 1e-6).all(), "router probabilities tie: top-k ambiguous"


# -- configs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get_j, get_t in ((j_full, t_full), (j_smoke, t_smoke)):
        j, t = get_j(arch), get_t(arch)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta",
                  "pad_heads_to", "remat_policy", "loss_chunk", "grad_accum",
                  "padded_heads", "padded_vocab"):
            assert getattr(t, f) == getattr(j, f), f
        for f in dataclasses.fields(j.moe):
            assert getattr(t.moe, f.name) == getattr(j.moe, f.name), f.name
        assert t.moe.padded_experts == j.moe.padded_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_active_params_match_reference(arch):
    def shapes(tree, prefix=""):
        if hasattr(tree, "shape") and not isinstance(tree, dict):
            return {prefix: tuple(tree.shape)}
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}/{k}"))
        return out

    jcfg, tcfg = _cfgs(arch)
    assert shapes(t_build(tcfg).param_specs()) == \
        shapes(j_build(jcfg).param_specs())
    assert t_active(t_full(arch)) == j_active(j_full(arch))
    assert t_active(tcfg) == j_active(jcfg)


# -- routing, the capacity drop and the combine ---------------------------


@pytest.mark.parametrize("t", [4, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, t, donors):
    jcfg, tcfg = _cfgs(arch)
    p = _moe_layer(donors[arch], arch)
    x = _tokens(arch, t)
    jprobs, jexp, jaux = jmoe._route(jax.tree.map(jnp.asarray, p), jcfg,
                                     jnp.asarray(x), jnp.float32)
    logits = x @ p["router"]["kernel"]
    logits[:, jcfg.moe.n_experts:] = -1e30
    full = np.exp(logits - logits.max(-1, keepdims=True))
    _no_near_ties(full / full.sum(-1, keepdims=True), jcfg.moe.top_k)
    tprobs, texp, taux = tmoe._route(params_from_jax(p, "cpu"), tcfg,
                                     torch.from_numpy(x), torch.float32)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    assert texp.max() < tcfg.moe.n_experts  # no padded expert wins
    _close(tprobs, jprobs, 1e-6)
    for n in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[n]), float(jaux[n]), rtol=1e-6)


def _ref_positions(experts, E, cap):
    """The reference's slot arithmetic, step by step (``_moe_body``)."""
    flat_e = jnp.asarray(experts).reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    flat_pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(flat_pos), np.asarray(flat_pos < cap)


@pytest.mark.parametrize("t", [1, 4, 192])
def test_capacity_drop_matches_reference(t):
    """granite's full config: ``cap = ceil(t * 8 * 1.25 / 40)`` is 1 at a
    B = 4 decode step and 48 at a 192-token prefill.  Slots come from the
    exclusive count in token-major ``[t * k]`` order, and entries past the
    capacity drop, exactly as the reference's."""
    cfg = t_full("granite-moe-3b-a800m")
    k, E = cfg.moe.top_k, cfg.moe.padded_experts
    rng = np.random.default_rng(t)
    experts = np.stack([rng.choice(cfg.moe.n_experts, k, replace=False)
                        for _ in range(t)])
    cap = tmoe.moe_capacity(cfg, t)
    assert cap == {1: 1, 4: 1, 192: 48}[t]
    want_pos, want_keep = _ref_positions(experts, E, cap)
    flat_e, flat_pos, keep = tmoe._dispatch(cfg, torch.from_numpy(experts),
                                            cap)
    np.testing.assert_array_equal(flat_pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert tmoe.dropped_entries(cfg, torch.from_numpy(experts), t) == \
        int((~want_keep).sum())
    if t == 1:
        assert want_keep.all()  # one token routes k distinct experts


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [4, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, t, dt, donors):
    """Dispatch, the expert FFNs and the combine (each token's k
    contributions added in the compute dtype, in the reference's order).
    At t = 40 granite's smoke experts overflow their capacity."""
    jcfg, tcfg = _cfgs(arch, dt)
    p = _moe_layer(donors[arch], arch)
    x = _tokens(arch, t, seed=5).reshape(2, t // 2, -1)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, CTX,
                              jnp.asarray(x).astype(jcfg.dtype))
    ty, taux = tmoe.moe_apply(params_from_jax(p, "cpu"), tcfg,
                              torch.from_numpy(x).to(tcfg.dtype))
    assert ty.dtype == tcfg.dtype and ty.shape == tuple(jy.shape)
    _close(ty, jy, 1e-5 if dt == "f32" else 2e-2)
    for n in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[n]), float(jaux[n]),
                                   rtol=1e-5 if dt == "f32" else 2e-2)


def test_overflow_drops_entries_at_the_smoke_config(donors):
    """Eight copies of one token route to the same four experts: each gets
    eight entries against a capacity of 4, so half of them drop, and the
    layer still equals the reference's (float32, 1e-5)."""
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = _cfgs(arch)
    p = _moe_layer(donors[arch], arch)
    x = np.repeat(_tokens(arch, 1, seed=5), 8, 0)
    tp = params_from_jax(p, "cpu")
    _, experts, _ = tmoe._route(tp, tcfg, torch.from_numpy(x), torch.float32)
    assert tmoe.moe_capacity(tcfg, 8) == 4
    assert tmoe.dropped_entries(tcfg, experts, 8) == 16
    jy, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg, CTX,
                           jnp.asarray(x)[None])
    ty, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x)[None])
    _close(ty, jy, 1e-5)
    assert (np.abs(_np(ty)[0, 4:]) == 0).all()  # the dropped tokens add 0


# -- the whole model -------------------------------------------------------


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)),
            "labels": rng.integers(0, cfg.vocab, (B, S))}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dt, donors):
    """``loss`` (CE + z + the aux losses over the units) and its metrics;
    in float32 every gradient too."""
    jcfg, tcfg = _cfgs(arch, dt)
    batch = _batch(jcfg)
    jm = j_build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, CTX), has_aux=True)(
        jax.tree.map(jnp.asarray, donors[arch]))
    tp = params_from_jax(donors[arch], "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, tmet = t_build(tcfg).loss(tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    assert set(tmet) == set(jmet) == {"ce", "z", "load_balance", "router_z"}
    for n in jmet:
        np.testing.assert_allclose(float(tmet[n]), float(jmet[n]), rtol=tol,
                                   err_msg=n)
    if dt == "bf16":
        return
    tg = dict(zip(_flat(tp), torch.autograd.grad(tl, leaves)))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    for k, want in jflat.items():
        _close(tg[k], want, 1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dt, donors):
    """A 10-token prompt at B = 2, then four decode steps, each from the
    reference's cache (a bfloat16 cache entry can round the other way at a
    tie; the written caches are held within one bfloat16 step)."""
    jcfg, tcfg = _cfgs(arch, dt)
    jm = j_build(jcfg)
    jp = jax.tree.map(jnp.asarray, donors[arch])
    tp = params_from_jax(donors[arch], "cpu")
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 10))
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, {"tokens":
                                               torch.from_numpy(tokens)})
    _close(tl_, jl_, 1e-5 if dt == "f32" else 2e-2)
    assert tc["pos"] == int(jc["pos"]) == 10
    assert sorted(tc["layers"]) == sorted(jc["layers"])
    step = make_decode_step(tcfg)
    for _ in range(4):
        for sub in jc["layers"]:
            for n in ("k", "v"):
                _close(tc["layers"][sub][n], jc["layers"][sub][n],
                       2 ** -7 if dt == "f32" else 2e-2)
        tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                     jc["layers"]), "pos": int(jc["pos"])}
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, tc, torch.from_numpy(tok))
        _close(tl_[:, :jcfg.vocab], jl_[:, :jcfg.vocab],
               1e-4 if dt == "f32" else 2e-2)
    assert tc["pos"] == int(jc["pos"]) == 14


def test_engine_serves_the_reference_tokens():
    """granite's smoke config: three requests of 8 new tokens over 2 slots
    (prompts replayed into the cache, a slot recycled), the same tokens as
    the JAX engine on the same parameters."""
    jcfg = j_smoke("granite-moe-3b-a800m")
    with hash_free_engines():
        jeng = js.Engine(jcfg, max_len=64, slots=2)
    jreqs = js._make_requests(jcfg, 3, 8, None, 0)
    jstats = jeng.run(jreqs)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    tcfg = t_smoke("granite-moe-3b-a800m")
    teng = ts.Engine(tcfg, 64, 2, device="cpu", params=params)
    treqs = ts.make_requests(tcfg, 3, 8, 0)
    tstats = teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.outcome for r in treqs] == ["served"] * 3
    assert tstats["served"] == jstats["served"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_and_trains_the_smoke_config(arch, capsys, tmp_path):
    """``--arch`` through the serving and training launchers on the CPU."""
    from repro_torch.launch import train as ttrain

    stats = ts.run_cli(t_smoke(arch), ts.parse_args(
        ["--arch", arch, "--requests", "2", "--max-new", "3", "--device",
         "cpu"]))
    assert stats["served"] == 2
    out = ttrain.main(["--arch", arch, "--steps", "3", "--seq", "16",
                       "--batch", "4", "--log-every", "1", "--ckpt-dir",
                       str(tmp_path), "--device", "cpu"])
    assert out["step"] == 3 and all(np.isfinite(out["losses"]))
    assert "load_balance" in capsys.readouterr().out
