"""Port parity: expert parallelism (``nn.moe.moe_apply`` under a ctx, the
MoE ``TransformerLM`` on a mesh, ``make_train_step(cfg, mesh)`` and
``Engine(mesh=)`` for an MoE config).

granite-moe-3b-a800m's and llama4-maverick's smoke configs on CPU meshes
of ``"cpu"`` devices, (1, 2), (1, 4), (2, 2) and (2, 4), the parameters
placed by ``nn.module.shardings``, held against:

* the reference's own mesh run, in one module-scoped subprocess with 8
  forced host devices and ``Auto`` mesh axes (as
  ``test_torch_mesh_serving.py``'s ``REF_MESH``), at the published
  ``capacity_factor``: the layer in both schedules (a 4 x 8 input takes
  the all-to-all, a 4 x 1 one the psum) with its aux losses and each
  shard's routing and dropped entries, the prefill, a decode step from a
  seeded cache, ``loss(ctx=)`` and one probe train step (its loss and
  every gradient);
* the reference unsharded (in this process) and the port unsharded, at a
  drop-free copy of the config (``capacity_factor = n_experts / top_k``:
  a shard's capacity is its own token count, so no shard drops; at the
  published factor a shard drops at its own capacity and the mesh run
  differs from the unsharded one by design).  The aux losses are averaged
  over the shards' routings, so they (and the loss, which adds them) are
  held to the reference's mesh run only; against the unsharded runs the
  logits, ``ce`` and ``z``.

Tolerances, float32 compute: 1e-5 of the largest magnitude (the layer's
y, prefill logits, the loss's terms), the aux losses 1e-6 relative, the
dropped entries and the routing equal; a decode step reads its bfloat16
KV cache, so 1e-4 (the watch list's rule); the train step's gradients as
``test_torch_mesh_train.py`` holds them (1-D leaves 1e-5, bfloat16-cast
leaves 2**-7 of each leaf's largest).  bfloat16 compute is held to the
port unsharded at 2e-2 of the largest logit.  The layer's inputs are
checked first for router near-ties, as ``test_torch_moe.py`` does.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.steps import make_ctx as j_ctx
from repro.launch.steps import make_decode_step as j_decode
from repro.launch.steps import make_prefill_step as j_prefill
from repro.models import build_model as j_build
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import Engine, make_requests
from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model as t_build
from repro_torch.nn import module as tmod
from repro_torch.nn import moe as tmoe
from repro_torch.nn.layers import Rows
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_donor import jax_donor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
SHAPES = [(1, 2), (1, 4), (2, 2), (2, 4)]
#: the model-level cases the reference's mesh run covers (each compiles
#: for seconds; the train cases add (2, 2) and (1, 2))
MODEL_CASES = [("granite-moe-3b-a800m", (1, 2)),
               ("granite-moe-3b-a800m", (2, 4)),
               ("llama4-maverick-400b-a17b", (2, 2))]
TRAIN_CASES = [("granite-moe-3b-a800m", (2, 2)),
               ("llama4-maverick-400b-a17b", (1, 2))]
B, S, T = 4, 8, 16
TOL, DEC_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
PROBE = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)

#: the reference's own mesh run at the published capacity factor
REF_EP = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "tests")
from test_torch_donor import jax_donor
from test_torch_expert_parallel import (ARCHS, MODEL_CASES, SHAPES,
                                        TRAIN_CASES, config, flat, inputs,
                                        jax_cache, layer_inputs, moe_layer)
from repro.compat import shard_map
from repro.launch.steps import (make_ctx, make_decode_step,
                                make_prefill_step, make_train_step)
from repro.models import build_model
from repro.nn import moe as jmoe
from repro.nn.module import shardings
from repro.optim import AdamWConfig, adamw_init

assert jax.device_count() >= 8, jax.device_count()
probe = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)


def make(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def routes(cfg, mesh, router, x):
    """Each shard's experts [data, model, t, k], cut as moe_apply cuts."""
    tp = mesh.shape["model"]
    a2a = x.shape[1] % tp == 0 and x.shape[1] >= tp
    x_spec = P(("data",), "model" if a2a else None, None)

    def body(r, xl):
        _, e, _ = jmoe._route({"router": {"kernel": r}}, cfg,
                              xl.reshape(-1, xl.shape[-1]), cfg.dtype)
        return e[None, None]

    return shard_map(body, mesh=mesh, in_specs=(P(None, None), x_spec),
                     out_specs=P("data", "model", None, None),
                     check_vma=False)(router, x)


out = {}
for arch in ARCHS:
    cfg = config(arch, "jax")
    model = build_model(cfg)
    specs = model.param_specs()
    p = jax_donor(specs, 0)
    lp = moe_layer(p, cfg)
    xs = {k: jnp.asarray(v) for k, v in layer_inputs(cfg).items()}
    for shape in SHAPES:  # both schedules in one compile a mesh
        mesh = make(shape)
        ctx = make_ctx(mesh)
        lpd = jax.device_put(lp, shardings(jmoe.moe_spec(cfg), mesh))
        got = jax.jit(lambda q, vs: {k: (
            jmoe.moe_apply(q, cfg, ctx, v),
            routes(cfg, mesh, q["router"]["kernel"], v))
            for k, v in vs.items()})(lpd, xs)
        for sched, ((y, aux), e) in got.items():
            tag = f"{arch}|{shape[0]}x{shape[1]}|{sched}"
            out[tag + "|y"] = np.asarray(y, np.float32)
            out[tag + "|aux"] = np.asarray(
                [aux["load_balance"], aux["router_z"]], np.float32)
            out[tag + "|experts"] = np.asarray(e, np.int64)
    ins = inputs(cfg, model)
    for a2, shape in MODEL_CASES:
        if a2 != arch:
            continue
        mesh = make(shape)
        tag = f"{arch}|{shape[0]}x{shape[1]}"
        pd = jax.device_put(p, shardings(specs, mesh))
        b = {"tokens": jnp.asarray(ins["tokens"])}
        ctx = make_ctx(mesh)
        pre, dec = make_prefill_step(cfg, mesh), make_decode_step(cfg, mesh)
        (lg, _), (ld, _), (lv, met) = jax.jit(  # one compile a case
            lambda q, bb, c, t: (pre(q, bb), dec(q, c, t),
                                 model.loss(q, dict(bb, labels=bb["labels"]),
                                            ctx)))(
            pd, dict(b, labels=jnp.asarray(ins["labels"])),
            jax_cache(model, ins["cache"]),
            jnp.asarray(ins["tok"], jnp.int32))
        out[tag + "|prefill"] = np.asarray(lg, np.float32)
        out[tag + "|decode"] = np.asarray(ld, np.float32)
        out[tag + "|loss"] = np.asarray(
            [lv, met["ce"], met["z"], met["load_balance"],
             met["router_z"]], np.float32)
    for a2, shape in TRAIN_CASES:
        if a2 != arch:
            continue
        mesh = make(shape)
        tag = f"{arch}|{shape[0]}x{shape[1]}|train"
        pd = jax.device_put(p, shardings(specs, mesh))
        b = {"tokens": jnp.asarray(ins["tokens"]),
             "labels": jnp.asarray(ins["labels"])}
        _, st, met = jax.jit(make_train_step(cfg, mesh, probe))(
            pd, adamw_init(pd, probe), b)
        out[tag + "|metrics"] = np.asarray(
            [met[k] for k in ("loss", "ce", "z", "grad_norm")], np.float32)
        for path, g in flat(st["m"]).items():
            out[f"{tag}|g|{path}"] = np.asarray(
                jnp.asarray(g).astype(jnp.float32))
np.savez(sys.argv[1], **out)
'''


def config(arch, pkg, dtype="float32", dropfree=False):
    """The smoke config of ``arch`` in either package, computing in
    ``dtype``; ``dropfree`` raises the capacity factor to ``n_experts /
    top_k``, the least at which no expert drops an entry."""
    cfg = (j_smoke if pkg == "jax" else t_smoke)(arch)
    if dropfree:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    return dataclasses.replace(cfg, dtype=getattr(
        jnp if pkg == "jax" else torch, dtype))


def moe_layer(params, cfg):
    """The first MoE block's ``moe`` parameters (the unit's last block)."""
    sub = f"sub{cfg.moe.interleave - 1}"
    return jax.tree.map(lambda a: a[0], params["blocks"][sub]["moe"])


def layer_inputs(cfg):
    """The layer's seeded inputs: ``[B, S, d]`` (all-to-all on every
    tested mesh) and ``[B, 1, d]`` (psum)."""
    rng = np.random.default_rng(5)
    return {"a2a": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32),
            "psum": rng.standard_normal((B, 1, cfg.d_model))
            .astype(np.float32)}


def inputs(cfg, model):
    """The model-level inputs: prompt tokens, labels, a seeded decode cache
    (numpy, by leaf path) and the decode tokens."""
    rng = np.random.default_rng(7)
    cache = {path: (0.5 * rng.normal(size=s.shape)).astype(np.float32)
             for path, s in flat(model.cache_specs(B, T)["layers"]).items()}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64),
            "cache": cache,
            "tok": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int64)}


def flat(tree, prefix=""):
    """A tree's leaves by ``a/b/c`` path (placed leaves joined)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tmod.Placed):
        tree = tree.join()
    return {prefix: tree}


def _set(tree, path, value):
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def jax_cache(model, cache):
    """The reference's decode cache holding the seeded values, ``pos`` = T
    - 3."""
    c = jax_donor(model.cache_specs(B, T), 1)
    for path, a in cache.items():
        leaf = flat(c["layers"])[path]
        _set(c["layers"], path, jnp.asarray(a).astype(leaf.dtype))
    c["pos"] = jnp.asarray(T - 3, jnp.int32)
    return c


def port_cache(model, cache):
    c = tmod.materialize(model.cache_specs(B, T), 1, device="cpu")
    for path, a in cache.items():
        leaf = flat(c["layers"])[path]
        _set(c["layers"], path, torch.from_numpy(a).to(leaf.dtype))
    c["pos"] = T - 3
    return c


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol, scale=None):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small, and the other test
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_ep(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ep.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REF_EP, str(out)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def donors():
    return {a: jax.tree.map(np.asarray, jax_donor(
        j_build(config(a, "jax")).param_specs(), 0)) for a in ARCHS}


def _placed(donor, cfg, mesh, specs=None):
    specs = specs if specs is not None else t_build(cfg).param_specs()
    return params_from_jax(donor, shardings=tmod.shardings(specs, mesh))


# -- the layer ---------------------------------------------------------------


def _no_near_ties(lp, cfg, x):
    logits = x.reshape(-1, x.shape[-1]) @ lp["router"]["kernel"]
    logits[:, cfg.moe.n_experts:] = -1e30
    p = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.sort(p / p.sum(-1, keepdims=True), -1)[:, ::-1]
    gaps = np.abs(np.diff(top[:, :cfg.moe.top_k + 1], axis=-1))
    assert (gaps > 1e-6).all(), "router probabilities tie: top-k ambiguous"


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_the_reference_mesh_run(ref_ep, donors, arch,
                                                  shape):
    """Both schedules at the published capacity: y (1e-5 of the largest),
    the averaged aux (1e-6 relative), every shard's routing and its
    dropped entries equal to the reference's mesh run."""
    cfg = config(arch, "torch")
    lp = moe_layer(donors[arch], cfg)
    mesh = _mesh(shape)
    ctx = make_ctx(mesh)
    placed = params_from_jax(lp, shardings=tmod.shardings(
        tmoe.moe_spec(cfg), mesh))
    assert placed["w_gate"].spec == ("model", "data", None)
    for sched, x in layer_inputs(cfg).items():
        _no_near_ties(lp, cfg, x)
        tag = f"{arch}|{_tag(shape)}|{sched}"
        with torch.no_grad(), tmoe.recording_routes() as log:
            y, aux = tmoe.moe_apply(placed, cfg,
                                    ctx.split_rows(torch.from_numpy(x)),
                                    ctx=ctx)
        assert isinstance(y, Rows)
        _close(ctx.join_rows(y), ref_ep[tag + "|y"], TOL)
        np.testing.assert_allclose(
            [float(aux["load_balance"]), float(aux["router_z"])],
            ref_ep[tag + "|aux"], rtol=1e-6)
        (routed,) = log
        want = ref_ep[tag + "|experts"]
        assert sorted(routed) == sorted(np.ndindex(*want.shape[:2]))
        dropped = tmoe.dropped_entries(cfg, routed)
        for c, e in routed.items():
            np.testing.assert_array_equal(e.numpy(), want[c])
            assert dropped[c] == tmoe.dropped_entries(
                cfg, torch.from_numpy(want[c]))
        if sched == "psum":  # every shard of a row routes the row's tokens
            assert len({(c[0], tuple(e.reshape(-1).tolist()))
                        for c, e in routed.items()}) == shape[0]


def test_published_capacity_drops_per_shard(ref_ep):
    """At the published factor the all-to-all's shards drop at their own
    capacity: on (1, 4) granite's smoke layer drops entries, shard by
    shard as the reference's mesh run (above); the count is not the
    unsharded layer's."""
    cfg = config("granite-moe-3b-a800m", "torch")
    want = ref_ep["granite-moe-3b-a800m|1x4|a2a|experts"]
    per = [tmoe.dropped_entries(cfg, torch.from_numpy(want[0, j]))
           for j in range(4)]
    whole = tmoe.dropped_entries(cfg, torch.from_numpy(
        np.concatenate([want[0, j] for j in range(4)])))
    assert sum(per) > 0 and sum(per) != whole, (per, whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_on_a_mesh_is_the_unsharded_layer_when_nothing_drops(
        donors, arch):
    """Drop-free: both schedules' y on every mesh equal the port's and the
    reference's unsharded layer (1e-5)."""
    from repro.nn import moe as jmoe
    from repro.nn.layers import Ctx

    tcfg, jcfg = config(arch, "torch", dropfree=True), \
        config(arch, "jax", dropfree=True)
    lp = moe_layer(donors[arch], tcfg)
    for x in layer_inputs(tcfg).values():
        jy, _ = jax.jit(lambda q, v: jmoe.moe_apply(q, jcfg, Ctx(), v))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
        with torch.no_grad():
            ty, _ = tmoe.moe_apply(params_from_jax(lp, "cpu"), tcfg,
                                   torch.from_numpy(x))
        _close(ty, jy, TOL)
        for shape in SHAPES:
            mesh = _mesh(shape)
            ctx = make_ctx(mesh)
            placed = params_from_jax(lp, shardings=tmod.shardings(
                tmoe.moe_spec(tcfg), mesh))
            with torch.no_grad():
                y, _ = tmoe.moe_apply(placed, tcfg,
                                      ctx.split_rows(torch.from_numpy(x)),
                                      ctx=ctx)
            _close(ctx.join_rows(y), jy, TOL)
            _close(ctx.join_rows(y), ty, TOL)


# -- the model ---------------------------------------------------------------


def _ids(c):
    return f"{c[0].split('-')[0]}-{_tag(c[1])}"


def _model_run(arch, donor, shape, dropfree=False, dtype="float32"):
    """The port's prefill logits, decode logits and loss metrics; on
    ``shape``'s mesh (placed parameters and cache) or unsharded."""
    cfg = config(arch, "torch", dtype, dropfree)
    m = t_build(cfg)
    ins = inputs(cfg, m)
    toks = torch.from_numpy(ins["tokens"])
    batch = {"tokens": toks, "labels": torch.from_numpy(ins["labels"])}
    cache = port_cache(m, ins["cache"])
    mesh = None if shape is None else _mesh(shape)
    if mesh is None:
        params = params_from_jax(donor, "cpu")
    else:
        params = _placed(donor, cfg, mesh, m.param_specs())
        cache = tmod.place(cache, tmod.shardings(m.cache_specs(B, T), mesh))
        assert tmod.check_placed_bytes(params) > 0
    with torch.no_grad():
        pre, _ = make_prefill_step(cfg, mesh)(params, {"tokens": toks})
        dec, _ = make_decode_step(cfg, mesh)(params, cache,
                                             torch.from_numpy(ins["tok"]))
        lv, met = m.loss(params, batch, ctx=make_ctx(mesh))
    return pre, dec, np.asarray([float(lv)] + [float(met[k]) for k in (
        "ce", "z", "load_balance", "router_z")], np.float32)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
def test_model_on_mesh_matches_the_reference_mesh_run(ref_ep, donors, case):
    """Prefill (all-to-all), a decode step (psum) and ``loss(ctx=)`` at the
    published capacity against the reference's run on the same mesh: the
    logits (1e-5; decode 1e-4), the loss, ``ce``, ``z`` and the averaged
    aux losses (1e-5 relative)."""
    arch, shape = case
    pre, dec, loss = _model_run(arch, donors[arch], shape)
    tag = f"{arch}|{_tag(shape)}"
    _close(pre, ref_ep[tag + "|prefill"], TOL)
    vocab = t_smoke(arch).vocab
    _close(dec[:, :vocab], ref_ep[tag + "|decode"][:, :vocab], DEC_TOL)
    np.testing.assert_allclose(loss, ref_ep[tag + "|loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def unsharded(donors):
    """Per arch: the reference's and the port's unsharded drop-free
    prefill, decode and loss."""
    out = {}
    for arch in ARCHS:
        jcfg = config(arch, "jax", dropfree=True)
        jm = j_build(jcfg)
        ins = inputs(jcfg, jm)
        jp = jax.tree.map(jnp.asarray, donors[arch])
        b = {"tokens": jnp.asarray(ins["tokens"])}
        jpre, _ = jax.jit(j_prefill(jcfg, None))(jp, b)
        jdec, _ = jax.jit(j_decode(jcfg, None))(
            jp, jax_cache(jm, ins["cache"]), jnp.asarray(ins["tok"],
                                                         jnp.int32))
        _, jmet = jax.jit(lambda q, bb: jm.loss(q, bb, j_ctx(None)))(
            jp, dict(b, labels=jnp.asarray(ins["labels"])))
        out[arch] = {"jax": (jpre, jdec, np.asarray(
            [0.0, jmet["ce"], jmet["z"]], np.float32)),
            "port": _model_run(arch, donors[arch], None, True)}
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_on_mesh_is_the_unsharded_model_when_nothing_drops(
        unsharded, donors, arch, shape):
    """Drop-free: the prefill (1e-5), the decode step (1e-4), ``ce`` and
    ``z`` (1e-5 relative) on the mesh against the reference unsharded and
    the port unsharded."""
    pre, dec, loss = _model_run(arch, donors[arch], shape, dropfree=True)
    vocab = t_smoke(arch).vocab
    for pkg in ("jax", "port"):
        wpre, wdec, wloss = unsharded[arch][pkg]
        _close(pre, wpre, TOL)
        _close(dec[:, :vocab], _np(wdec)[:, :vocab], DEC_TOL)
        np.testing.assert_allclose(loss[1:3], np.asarray(wloss)[1:3],
                                   rtol=1e-5, err_msg=pkg)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_on_mesh_matches_unsharded(donors, arch, shape):
    """bfloat16 compute, drop-free: the mesh's prefill and decode step
    against the port unsharded, 2e-2 of the largest logit."""
    vocab = t_smoke(arch).vocab
    want = _model_run(arch, donors[arch], None, True, "bfloat16")
    got = _model_run(arch, donors[arch], shape, True, "bfloat16")
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.bfloat16
        _close(g[:, :vocab], w[:, :vocab], BF16_TOL)


# -- training ----------------------------------------------------------------


def _train_step(arch, donor, shape, dropfree=False):
    cfg = config(arch, "torch", dropfree=dropfree)
    m = t_build(cfg)
    ins = inputs(cfg, m)
    mesh = None if shape is None else _mesh(shape)
    params = params_from_jax(donor, "cpu") if mesh is None else \
        _placed(donor, cfg, mesh, m.param_specs())
    _, st, met = make_train_step(cfg, mesh, PROBE)(
        params, adamw_init(params, PROBE),
        {"tokens": torch.from_numpy(ins["tokens"]),
         "labels": torch.from_numpy(ins["labels"])})
    return (np.asarray([float(met[k]) for k in ("loss", "ce", "z",
                                                 "grad_norm")], np.float32),
            flat(st["m"]))


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_ids)
def test_train_step_on_mesh_matches_the_reference_mesh_run(ref_ep, donors,
                                                           case):
    """One probe step (the first moment is the gradient) on the mesh at the
    published capacity against the reference's step on the same mesh:
    loss, ce, z (1e-5), the global norm (2**-7) and every leaf's gradient
    (1-D leaves 1e-5, bfloat16-cast leaves 2**-7 of each leaf's largest);
    drop-free, ``ce`` and ``z`` against the port unsharded."""
    arch, shape = case
    metrics, grads = _train_step(arch, donors[arch], shape)
    tag = f"{arch}|{_tag(shape)}|train"
    want = ref_ep[tag + "|metrics"]
    np.testing.assert_allclose(metrics[:3], want[:3], rtol=1e-5)
    np.testing.assert_allclose(metrics[3], want[3], rtol=2 ** -7)
    wg = {k.split("|g|", 1)[1]: v for k, v in ref_ep.items()
          if k.startswith(tag + "|g|")}
    assert sorted(grads) == sorted(wg)
    for k, w in wg.items():
        g = _np(grads[k])
        tol = 2 ** -7 if g.ndim > 1 else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=k)
    got, _ = _train_step(arch, donors[arch], shape, dropfree=True)
    whole, _ = _train_step(arch, donors[arch], None, dropfree=True)
    np.testing.assert_allclose(got[1:3], whole[1:3], rtol=1e-5)


def test_trainer_runs_an_moe_config_data_parallel(tmp_path, capsys):
    """``launch.train.run`` on a (data=2, model=1) mesh of CPU devices:
    the all-to-all with ``tp = 1``, each row routing its own tokens; the
    losses finite and the aux losses logged."""
    from repro_torch.launch import train

    cfg = t_smoke("granite-moe-3b-a800m")
    args = train.parse_args(["--steps", "2", "--seq", "16", "--batch", "4",
                             "--log-every", "1", "--ckpt-dir",
                             str(tmp_path), "--device", "cpu"])
    out = train.run(cfg, args, mesh=_mesh((2, 1)))
    assert out["step"] == 2 and all(np.isfinite(out["losses"]))
    assert isinstance(out["params"]["blocks"]["sub0"]["moe"]["w_up"],
                      tmod.Placed)
    assert "load_balance" in capsys.readouterr().out


# -- serving -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_mesh_serves_the_unsharded_tokens(arch, shape):
    """``Engine(cfg, 64, 4, mesh)`` at drop-free capacity serves 4
    requests with the unsharded engine's tokens (every step the psum
    schedule); its expert leaves are placed and pass the byte check."""
    cfg = config(arch, "torch", "bfloat16", dropfree=True)
    want = make_requests(cfg, 4, 6, 0, None)
    Engine(cfg, 64, 4, device="cpu").run(want)
    eng = Engine(cfg, 64, 4, _mesh(shape), device="cpu")
    sub = f"sub{cfg.moe.interleave - 1}"
    w = eng.params["blocks"][sub]["moe"]["w_gate"]
    assert isinstance(w, tmod.Placed) and w.spec[1] == "model"
    assert not [p for p in eng.replicated_leaves if "/moe/" in p]
    got = make_requests(cfg, 4, 6, 0, None)
    eng.run(got)
    assert [r.out for r in got] == [r.out for r in want]


def test_llama4_full_width_bytes_a_device_on_1x4():
    """llama4-maverick at its published width on (1, 4), reckoned from the
    specs with nothing allocated: every expert leaf a quarter a device,
    none replicated by the fallback; one MoE layer's experts are 64.4 GB
    whole in float32."""
    cfg = t_full("llama4-maverick-400b-a17b")
    specs = t_build(cfg).param_specs()
    mesh = _mesh((1, 4))
    structs = tmod.shape_structs(specs, mesh)
    layer = 0
    for name in ("w_gate", "w_up", "w_down"):
        t = structs["blocks"]["sub1"]["moe"][name]
        assert t.device.type == "meta" and t.sharding.spec[1] == "model"
        whole = tmod.spec_bytes(specs["blocks"]["sub1"]["moe"][name])
        assert math.prod(t.sharding.counts) == 4
        layer += whole // t.shape[0]
    assert round(layer / 1e9, 1) == 64.4
    assert not [p for p in tmod.fallback_leaves(specs, mesh) if "/moe/" in p]
