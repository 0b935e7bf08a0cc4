"""Port parity: the dense family and the Mamba engine served on a mesh.

The steps (``make_prefill_step(cfg, mesh)``, ``make_decode_step(cfg,
mesh, rule_overrides)``) on CPU meshes of ``"cpu"`` devices, with the
parameters and the cache placed by ``nn.module.shardings``, for
qwen3-0.6b, qwen1.5-4b with padded heads (3 heads padded to 4),
whisper-medium and llava-next-mistral-7b (prefill and decode),
mamba2-130m (decode) and whisper-medium's decode under the reference dry
run's ``kvshard`` rules (the query heads replicated: each shard gathers
the cross K/V heads of every model shard), each held against:

* the reference unsharded, in this process;
* the reference's own mesh run, in a subprocess with 8 forced host
  devices and ``Auto`` mesh axes (a module-scoped fixture; the
  reference's ``make_host_mesh`` builds ``Explicit`` axes, under which its
  mesh path fails in this JAX);
* the port unsharded.

The three-way parity runs the configs with float32 compute (the bfloat16
steps of the two packages differ by up to 2e-2 of the largest logit with
these inputs whatever the mesh, which would hide a mesh's error): 1e-4 of
the largest |logit| of the unsharded step (the reference's own mesh run
is within 1e-5 of its unsharded one).  The bfloat16 steps are held to
the port unsharded: 1e-2 of the largest |logit|.  The converted Mamba
decode under a ``ctx`` (float32 tables): 2e-4 of the largest logit
against the unsharded conversion.
The dense family's ``loss(ctx=)`` is held to the same three references
(the loss, ``ce`` and ``z``, 1e-4 of the unsharded loss).
A mesh decode step writes the given cache in place (the reference donates
it).  The ``Engine(mesh=)``: the unsharded engine's tokens, the restart (a step
fault) and rollback (a table breach) contract on a (1, 2) mesh, the
refusal of a hybrid config, the per-device byte check.
"""

import dataclasses
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
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.core.serving import convert_mamba_decode
from repro_torch.interop import params_from_jax, to_torch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import Engine, _chaos_plan, make_requests
from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import build_model as t_build
from repro_torch.nn import module as tmod
from repro_torch.runtime import FaultInjector
from test_torch_donor import jax_donor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # of the largest |logit| of the unsharded step (float32)
BF16_TOL = 1e-2  # of the largest |logit| of the unsharded step (bfloat16)
PCILT_TOL = 2e-4  # float32 tables

#: the reference's own mesh run: the smoke configs on the seeded donor,
#: placed by its ``shardings`` on ``Auto``-axes meshes; the inputs are
#: saved beside the logits
REF_MESH = r'''
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, "tests")
from test_torch_donor import jax_donor
from test_torch_mesh_serving import (CASES, config, make_inputs, make_labels,
                                     to_jax_cache)
from repro.launch.steps import make_ctx, make_decode_step, make_prefill_step
from repro.models import build_model
from repro.nn.module import shardings

assert jax.device_count() >= 8, jax.device_count()
out = {}
for arch in sorted({c[0] for c in CASES}):
    cfg = config(arch, "jax")
    model = build_model(cfg)
    specs = model.param_specs()
    params = jax_donor(specs, 0)
    cache, tok, batch = make_inputs(cfg, model)
    for name, a in (("tok", tok), *batch.items()):
        out[f"{arch}|in|{name}"] = a
    for k, a in cache.items():
        out[f"{arch}|cache|{k}"] = a
    jcache = jax_donor(model.cache_specs(4, 16), 1)
    for a2, shape, ov in CASES:
        if a2 != arch:
            continue
        tag = f"{arch}|{shape[0]}x{shape[1]}|{bool(ov)}"
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        pd = jax.device_put(params, shardings(specs, mesh))
        jc = to_jax_cache(jcache, cache)
        l, _ = jax.jit(make_decode_step(cfg, mesh, ov))(
            pd, jc, jnp.asarray(tok, jnp.int32))
        out[tag + "|decode"] = np.asarray(l, np.float32)
        if cfg.family != "ssm" and not ov:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            lp, _ = jax.jit(make_prefill_step(cfg, mesh, ov))(pd, jb)
            out[tag + "|prefill"] = np.asarray(lp, np.float32)
            ctx = make_ctx(mesh, ov)
            lv, met = jax.jit(lambda p, b: model.loss(p, b, ctx))(
                pd, dict(jb, labels=jnp.asarray(make_labels(cfg))))
            out[tag + "|loss"] = np.asarray([lv, met["ce"], met["z"]],
                                            np.float32)
np.savez(sys.argv[1], **out)
'''

B, T, S = 4, 16, 8
#: the reference dry run's ``kvshard`` variant: the cache's time axis over
#: the model axis, the query heads replicated
KVSHARD = {"cache_seq": "model", "heads": None}
CASES = [(a, s, None) for a in ("qwen3-0.6b", "qwen1.5-4b-padded",
                                 "whisper-medium", "llava-next-mistral-7b",
                                 "mamba2-130m")
         for s in ((1, 2), (2, 2))] + [("qwen3-0.6b", (1, 4),
                                        {"cache_seq": "model"})] \
    + [("whisper-medium", s, KVSHARD) for s in ((1, 2), (2, 2))]
PREFILL = [c for c in CASES if c[0] != "mamba2-130m" and c[2] is None]


def config(arch, pkg, dtype="float32"):
    """The smoke config of ``arch`` in either package, computing in
    ``dtype``; ``qwen1.5-4b-padded`` pads 3 heads (and KV heads) to 4."""
    cfg = (j_smoke if pkg == "jax" else t_smoke)(
        arch.removesuffix("-padded"))
    if arch.endswith("-padded"):
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3,
                                  pad_heads_to=4, pad_kv_heads_to=4)
    return dataclasses.replace(cfg, dtype=getattr(
        jnp if pkg == "jax" else torch, dtype))


def make_inputs(cfg, model):
    """The seeded decode cache (numpy, by leaf path), tokens and prefill
    batch of one config."""
    rng = np.random.default_rng(7)
    cache = {}
    specs = model.cache_specs(B, T)["layers"]
    for path, s in _flat(specs).items():
        cache[path] = (0.5 * rng.normal(size=s.shape)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int64)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
    if cfg.encoder_layers:
        batch["memory"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return cache, tok, batch


def make_labels(cfg):
    """The seeded labels ``[B, S]`` of the loss (over the text positions)."""
    return np.random.default_rng(11).integers(
        0, cfg.vocab, (B, S)).astype(np.int64)


def _flat(tree, prefix=""):
    if hasattr(tree, "shape") and not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _set(tree, path, value):
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def to_jax_cache(jcache, cache):
    """The reference's cache (its spec dtypes) holding the seeded values,
    ``pos`` = T - 3."""
    out = jax.tree.map(lambda a: a, jcache)
    for path, a in cache.items():
        leaf = _flat(out["layers"])[path]
        _set(out["layers"], path, jnp.asarray(a).astype(leaf.dtype))
    out["pos"] = jnp.asarray(T - 3, jnp.int32)
    return out


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "mesh.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REF_MESH, str(out)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def problems(ref_mesh):
    """Per architecture: the port's model, the donor (numpy), the inputs,
    the reference's unsharded logits (this process) and the port's."""
    out = {}
    for arch in sorted({c[0] for c in CASES}):
        jcfg, tcfg = config(arch, "jax"), config(arch, "torch")
        jm, tm = j_build(jcfg), t_build(tcfg)
        jparams = jax_donor(jm.param_specs(), 0)
        np_params = jax.tree.map(np.asarray, jparams)
        cache = {k.split("|", 2)[2]: v for k, v in ref_mesh.items()
                 if k.startswith(f"{arch}|cache|")}
        ins = {k.split("|", 2)[2]: v for k, v in ref_mesh.items()
               if k.startswith(f"{arch}|in|")}
        tok = ins.pop("tok")
        jc = to_jax_cache(jax_donor(jm.cache_specs(B, T), 1), cache)
        jl, _ = jax.jit(j_decode(jcfg, None))(jparams, jc,
                                              jnp.asarray(tok, jnp.int32))
        p = {"tm": tm, "tcfg": tcfg, "np_params": np_params,
             "cache": cache, "tok": torch.from_numpy(tok), "batch":
             {k: torch.from_numpy(v) for k, v in ins.items()},
             "j_decode": np.asarray(jl, np.float32)}
        tparams = params_from_jax(np_params, "cpu")
        with torch.no_grad():
            p["t_decode"], p["t_cache"] = make_decode_step(tcfg)(
                tparams, _port_cache(tm, cache), p["tok"])
            if tcfg.family != "ssm":
                jb = {k: jnp.asarray(v) for k, v in ins.items()}
                jp, _ = jax.jit(j_prefill(jcfg, None))(jparams, jb)
                p["j_prefill"] = np.asarray(jp, np.float32)
                p["t_prefill"], p["t_pcache"] = make_prefill_step(tcfg)(
                    tparams, p["batch"])
                labels = make_labels(tcfg)
                jv, jmet = jax.jit(lambda q, b: jm.loss(q, b, j_ctx(None)))(
                    jparams, dict(jb, labels=jnp.asarray(labels)))
                p["j_loss"] = np.asarray([jv, jmet["ce"], jmet["z"]],
                                         np.float32)
                p["loss_batch"] = dict(p["batch"],
                                       labels=torch.from_numpy(labels))
                tv, tmet = tm.loss(tparams, p["loss_batch"])
                p["t_loss"] = np.asarray(
                    [float(tv), float(tmet["ce"]), float(tmet["z"])],
                    np.float32)
        out[arch] = p
    return out


def _port_cache(tm, cache):
    """The port's whole cache holding the seeded values (its spec dtypes),
    ``pos`` = T - 3."""
    c = tmod.materialize(tm.cache_specs(B, T), 1, device="cpu")
    for path, a in cache.items():
        leaf = _flat(c["layers"])[path]
        _set(c["layers"], path, torch.from_numpy(a).to(leaf.dtype))
    c["pos"] = T - 3
    return c


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _placed_inputs(p, shape, ov):
    mesh = _mesh(shape)
    rules = make_ctx(mesh, ov).rules
    tm = p["tm"]
    params = params_from_jax(p["np_params"], shardings=tmod.shardings(
        tm.param_specs(), mesh, rules))
    cache = tmod.place(_port_cache(tm, p["cache"]), tmod.shardings(
        tm.cache_specs(B, T), mesh, rules))
    assert tmod.check_placed_bytes(params) > 0
    tmod.check_placed_bytes(cache)
    return mesh, params, cache


def _close(got, want, scale, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float32)
                       - np.asarray(want, np.float32)).max())
    assert err <= tol * scale, (err, tol * scale)
    return err


def _one_bf16_step(got, want):
    """Every entry within one bfloat16 step of the unsharded cache's (a
    float32 ulp of the per-shard projection can round a bfloat16 entry
    the other way at a tie)."""
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= want.abs() * 2 ** -7).all())


def _ids(c):
    return f"{c[0]}-{c[1][0]}x{c[1][1]}" + ("-kvshard" if c[2] else "")


@pytest.mark.parametrize("case", [("qwen3-0.6b", (1, 2), None),
                                  ("qwen3-0.6b", (1, 4),
                                   {"cache_seq": "model"}),
                                  ("whisper-medium", (2, 2), KVSHARD)],
                         ids=_ids)
def test_mesh_decode_writes_the_given_cache_in_place(problems, case):
    """A decode step on the mesh writes its new K/V rows into the given
    placed cache, as the reference's donated step does: the returned
    ``layers`` are the given ones, every block keeps its storage
    (``data_ptr``), the given cache then joins to the port's unsharded new
    cache (within one bfloat16 step), and the logits equal a step on a
    copy of the cache bit for bit."""
    arch, shape, ov = case
    p = problems[arch]
    mesh, params, cache = _placed_inputs(p, shape, ov)
    ptrs = {path: {c: t.data_ptr() for c, t in leaf.blocks.items()}
            for path, leaf in _flat(cache["layers"]).items()}
    copy = dict(cache, layers={n: {k: v.clone() for k, v in sub.items()}
                               for n, sub in cache["layers"].items()})
    step = make_decode_step(p["tcfg"], mesh, ov)
    with torch.no_grad():
        logits, new = step(params, cache, p["tok"])
        again, _ = step(params, copy, p["tok"])
    assert new["layers"] is cache["layers"]
    for path, leaf in _flat(cache["layers"]).items():
        assert {c: t.data_ptr() for c, t in leaf.blocks.items()} == \
            ptrs[path], path
    joined = _flat(tmod.join(cache["layers"]))
    for path, t in _flat(p["t_cache"]["layers"]).items():
        _one_bf16_step(joined[path], t)
    assert torch.equal(logits, again)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_decode_on_mesh(problems, ref_mesh, case):
    """One decode step on the mesh against the reference unsharded, the
    reference on the same mesh and the port unsharded (logits); the new
    cache, joined, against the port's unsharded one."""
    arch, shape, ov = case
    p = problems[arch]
    mesh, params, cache = _placed_inputs(p, shape, ov)
    with torch.no_grad():
        logits, new = make_decode_step(p["tcfg"], mesh, ov)(params, cache,
                                                            p["tok"])
    got = logits.float().numpy()
    scale = float(np.abs(p["j_decode"]).max())
    _close(got, p["j_decode"], scale)
    _close(got, ref_mesh[f"{arch}|{shape[0]}x{shape[1]}|{bool(ov)}|decode"],
           scale)
    _close(got, p["t_decode"].float().numpy(), scale)
    joined = tmod.join(new["layers"])
    for path, t in _flat(p["t_cache"]["layers"]).items():
        w = _flat(joined)[path]
        assert w.shape == t.shape and w.dtype == t.dtype
        if t.dtype == torch.bfloat16:
            _one_bf16_step(w, t)
        else:
            _close(w.numpy(), t.numpy(), max(float(t.abs().max()), 1.0))
    assert new["pos"] == p["t_cache"]["pos"]


@pytest.mark.parametrize("case", PREFILL, ids=_ids)
def test_prefill_on_mesh(problems, ref_mesh, case):
    """A prefill on the mesh: the last position's logits against the three
    references; the cache comes back placed by the cache rules and joins
    to the port's unsharded one."""
    arch, shape, ov = case
    p = problems[arch]
    mesh, params, _ = _placed_inputs(p, shape, ov)
    with torch.no_grad():
        logits, cache = make_prefill_step(p["tcfg"], mesh, ov)(params,
                                                               p["batch"])
    got = logits.float().numpy()
    scale = float(np.abs(p["j_prefill"]).max())
    _close(got, p["j_prefill"], scale)
    _close(got, ref_mesh[f"{arch}|{shape[0]}x{shape[1]}|False|prefill"],
           scale)
    _close(got, p["t_prefill"].float().numpy(), scale)
    k = cache["layers"]["sub0"]["k"]
    assert isinstance(k, tmod.Placed)
    assert k.spec[1] == make_ctx(mesh).pspec(("batch",), (B,))[0]
    for name in ("k", "v"):
        _one_bf16_step(tmod.join(cache["layers"])["sub0"][name],
                       p["t_pcache"]["layers"]["sub0"][name])
    if "cross_kv" in cache:
        assert isinstance(cache["cross_kv"]["k"], tmod.Placed)


@pytest.mark.parametrize("case", PREFILL, ids=_ids)
def test_loss_on_mesh(problems, ref_mesh, case):
    """``loss(ctx=)`` on the mesh (placed parameters, the rows' final
    states joined, the vocab-parallel head): the loss, its ``ce`` and its
    ``z`` against the reference unsharded, the reference's own loss on the
    same ``Auto``-axes mesh and the port unsharded, within 1e-4 of the
    unsharded loss (float32 compute)."""
    arch, shape, ov = case
    p = problems[arch]
    mesh, params, _ = _placed_inputs(p, shape, ov)
    with torch.no_grad():
        v, met = p["tm"].loss(params, p["loss_batch"],
                              ctx=make_ctx(mesh, ov))
    got = np.asarray([float(v), float(met["ce"]), float(met["z"])],
                     np.float32)
    scale = float(np.abs(p["j_loss"][0]))
    _close(got, p["j_loss"], scale)
    _close(got, ref_mesh[f"{arch}|{shape[0]}x{shape[1]}|False|loss"], scale)
    _close(got, p["t_loss"], scale)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bf16_steps_match_unsharded(problems, case):
    """The bfloat16 configs: the mesh's decode (and prefill) against the
    port's unsharded step, 1e-2 of the largest |logit|."""
    arch, shape, ov = case
    p = dict(problems[arch], tcfg=config(arch, "torch", "bfloat16"))
    tcfg = p["tcfg"]
    whole = params_from_jax(p["np_params"], "cpu")
    mesh, params, cache = _placed_inputs(p, shape, ov)
    with torch.no_grad():
        want, _ = make_decode_step(tcfg)(whole, _port_cache(p["tm"],
                                                            p["cache"]),
                                         p["tok"])
        got, _ = make_decode_step(tcfg, mesh, ov)(params, cache, p["tok"])
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), want.float().numpy(),
               float(want.float().abs().max()), BF16_TOL)
        if tcfg.family != "ssm":
            want, _ = make_prefill_step(tcfg)(whole, p["batch"])
            got, _ = make_prefill_step(tcfg, mesh, ov)(params, p["batch"])
            _close(got.float().numpy(), want.float().numpy(),
                   float(want.float().abs().max()), BF16_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llava-next-mistral-7b"])
def test_batch_one_cache_time_shards_over_data(arch):
    """B = 1 on a (2, 2) mesh: the batch replicates, so the cache's time
    axis takes ``"data"`` (the reference's long-context case); each row
    attends over both time blocks (llava's past its window's wrap) and
    the step equals the unsharded one within 1e-2 of the largest
    |logit|, its cache within one bfloat16 step."""
    cfg = t_smoke(arch)
    m = t_build(cfg)
    params = tmod.materialize(m.param_specs(), 0, device="cpu")
    rng = np.random.default_rng(3)
    cache = tmod.materialize(m.cache_specs(1, T), 1, device="cpu")
    for n in ("k", "v"):
        t = cache["layers"]["sub0"][n]
        t.copy_(torch.from_numpy(0.5 * rng.normal(size=tuple(t.shape))
                                 .astype(np.float32)))
    cache["pos"] = T + 3 if cfg.window else T - 5
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1)))
    mesh = _mesh((2, 2))
    placed = tmod.place(cache, tmod.shardings(m.cache_specs(1, T), mesh))
    assert placed["layers"]["sub0"]["k"].spec[2] == "data"
    with torch.no_grad():
        want, wc = make_decode_step(cfg)(params, cache, tok)
        got, gc = make_decode_step(cfg, mesh)(
            tmod.place(params, tmod.shardings(m.param_specs(), mesh)),
            placed, tok)
    _close(got.float().numpy(), want.float().numpy(),
           float(want.float().abs().max()), BF16_TOL)
    _one_bf16_step(tmod.join(gc["layers"])["sub0"]["k"],
                   wc["layers"]["sub0"]["k"])


def test_no_sharded_leaf_is_held_whole(problems):
    """On (1, 4) qwen3-0.6b's KV heads and attention heads shard: no
    device holds a sharded leaf whole, the replicated norms once per
    distinct device, and a tampered block fails the byte check."""
    p = problems["qwen3-0.6b"]
    _, params, cache = _placed_inputs(p, (1, 4), None)
    wq = params["blocks"]["sub0"]["attn"]["wq"]["kernel"]
    assert all(b.shape[2] == 1 for b in wq.blocks.values())  # 4 heads / 4
    k = cache["layers"]["sub0"]["k"]
    assert k.spec == (None, "data", None, None, None)  # 2 KV heads: fallback
    assert len(params["ln_f"]["scale"].unique()) == 1
    bad = dict(params, ln_f={"scale": params["ln_f"]["scale"].clone()})
    bad["ln_f"]["scale"].blocks[(0, 3)] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="partition spec"):
        tmod.check_placed_bytes(bad)


# ----------------------------------------------------------------------------
# the converted Mamba decode under a ctx
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pcilt_pair(tmp_path_factory):
    from repro_torch.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    cfg = dataclasses.replace(t_smoke("mamba2-130m"),
                              pcilt=TPCILT(act_bits=2, group=2),
                              dtype=torch.float32)
    m = t_build(cfg)
    params = tmod.materialize(m.param_specs(), 0, device="cpu")
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))

    def convert(ctx=None):
        return convert_mamba_decode(m, params, calib, ctx=ctx, paired=True,
                                    head="shared", device="cpu")

    return {"cfg": cfg, "m": m, "params": params, "convert": convert}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pcilt_decode_under_ctx(pcilt_pair, shape):
    """``convert_mamba_decode(..., ctx=)``: the step with the SSD and conv
    state placed (and the recurrence per ``ssm_heads`` shard) equals the
    unsharded conversion's step within 2e-4 of the largest logit, the
    saturation counters exactly; the tables are the bundle's, whole."""
    pp = pcilt_pair
    m = pp["m"]
    mesh = _mesh(shape)
    ctx = make_ctx(mesh, None, decode=True)
    whole = pp["convert"]()
    sharded = pp["convert"](ctx)
    assert sharded.ctx is ctx
    rng = np.random.default_rng(5)
    cache = tmod.materialize(m.cache_specs(B), 5, device="cpu")
    for k, t in cache["layers"].items():
        t.copy_(torch.from_numpy(0.1 * rng.normal(size=tuple(t.shape))
                                 .astype(np.float32)))
    tok = torch.from_numpy(rng.integers(0, pp["cfg"].vocab, (B, 1)))
    placed = tmod.place(pp["params"], tmod.shardings(m.param_specs(), mesh))
    pc = tmod.place(cache, tmod.shardings(m.cache_specs(B), mesh))
    with torch.no_grad():
        want, wc, ws = whole.step(pp["params"], cache, tok, with_stats=True)
        got, gc, gs = sharded.step(placed, pc, tok, with_stats=True)
    scale = float(want.abs().max())
    _close(got.numpy(), want.numpy(), scale, PCILT_TOL)
    _close(tmod.join(gc["layers"])["ssd"].numpy(),
           wc["layers"]["ssd"].numpy(), 1.0, PCILT_TOL)
    assert torch.equal(tmod.join(gc["layers"])["conv"], wc["layers"]["conv"])
    for g in ("in", "conv", "out"):
        assert torch.equal(gs[g]["count"], ws[g]["count"]), g
    assert gc["layers"]["ssd"].spec[2] == ("model" if shape[1] > 1 else None)


# ----------------------------------------------------------------------------
# the Engine on a mesh
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_engine_mesh_serves_the_unsharded_tokens(arch):
    """``Engine(cfg, 64, 4, mesh)`` on (1, 2) and (2, 2) serves 4 requests
    with the unsharded engine's tokens; its parameters and cache are
    placed and pass the byte check."""
    cfg = t_smoke(arch)
    want = make_requests(cfg, 4, 6, 0, None)
    Engine(cfg, 64, 4, device="cpu").run(want)
    for shape in ((1, 2), (2, 2)):
        eng = Engine(cfg, 64, 4, _mesh(shape), device="cpu")
        assert isinstance(eng.params["embed"]["embedding"], tmod.Placed)
        assert tmod.check_placed_bytes(eng.cache) > 0
        got = make_requests(cfg, 4, 6, 0, None)
        eng.run(got)
        assert [r.out for r in got] == [r.out for r in want], shape


def test_engine_mesh_restart_contract():
    """A step fault on a (1, 2) mesh: the engine restores its placed cache
    from the checkpoint ring and replays; every request is served with the
    fault-free tokens."""
    cfg = t_smoke("qwen3-0.6b")
    mesh = _mesh((1, 2))
    want = make_requests(cfg, 4, 6, 0, None)
    Engine(cfg, 64, 4, mesh, device="cpu").run(want)
    eng = Engine(cfg, 64, 4, mesh, device="cpu")
    inj = FaultInjector(fail_at=(7,), seed=0)
    eng.chaos = {4: [lambda e: inj.maybe_fail(7)]}
    got = make_requests(cfg, 4, 6, 0, None)
    stats = eng.run(got)
    assert stats["restarts"] == 1 and inj.events
    assert all(r.outcome == "served" for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    snap = eng.ckpts[-1]["cache"]["layers"]["sub0"]["k"]
    assert isinstance(snap, tmod.Placed)
    assert all(a is not b for a, b in zip(
        snap.blocks.values(), eng.cache["layers"]["sub0"]["k"]
        .blocks.values()))


def test_engine_mesh_rollback_contract(pcilt_pair, tmp_path):
    """The paired PCILT engine on a (1, 2) mesh through the ``--chaos``
    plan (a garbled design cache, a step fault, NaN in the placed SSD
    state, a flipped projection stack, flipped head pointers): no request
    is lost, the step fault and the poisoned state restart, the table
    breaches roll back, and every request's tokens equal the fault-free
    run's."""
    from repro_torch.kernels import autotune as atn

    atn.reset_cache(str(tmp_path / "tiles.json"))
    pp = pcilt_pair
    cfg, params = pp["cfg"], pp["params"]
    mesh = _mesh((1, 2))
    want = make_requests(cfg, 4, 8, 0, None)
    Engine(cfg, 64, 4, mesh, pcilt=True, params=params,
           pcilt_bundle=pp["convert"]().pcilt, device="cpu").run(want)
    eng = Engine(cfg, 64, 4, mesh, pcilt=True, params=params,
                 pcilt_bundle=pp["convert"]().pcilt, device="cpu")
    assert isinstance(eng.cache["layers"]["ssd"], tmod.Placed)
    inj = FaultInjector(fail_at=(7,), seed=0)
    eng.chaos = _chaos_plan(eng, inj)
    got = make_requests(cfg, 4, 8, 0, None)
    stats = eng.run(got)
    assert not eng.chaos  # every fault fired
    assert stats["restarts"] >= 2 and stats["rollbacks"] >= 1
    assert all(r.outcome in ("served", "degraded") for r in got)
    assert [r.out for r in got] == [r.out for r in want]


def test_engine_mesh_refusals():
    """A hybrid config is refused under a mesh, as it is without one (an
    MoE config serves: ``test_torch_expert_parallel.py``)."""
    mesh = _mesh((1, 2))
    with pytest.raises(NotImplementedError, match="hybrid"):
        Engine(t_smoke("zamba2-7b"), 64, 2, mesh, device="cpu")
