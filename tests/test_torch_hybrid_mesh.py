"""Port parity: the hybrid family on a mesh, and the Mamba block's PCILT
conv and calibration under a ``ctx``.

zamba2-7b's smoke config cut to 4 Mamba2 blocks (segments of 3 and 1: 2
shared attention applications, one of each parameter set) through
``make_prefill_step(cfg, mesh)``, ``make_decode_step(cfg, mesh)`` and
``HybridLM.loss(ctx=)`` on CPU meshes of ``"cpu"`` devices, the
parameters and cache placed by ``nn.module.shardings``, held against:

* the reference unsharded, in this process;
* the reference's own mesh run, in a module-scoped subprocess with 8
  forced host devices and ``Auto`` mesh axes (the reference's
  ``make_host_mesh`` builds ``Explicit`` axes, under which its mesh path
  fails in this JAX);
* the port unsharded.

Parity runs in float32 compute: within 1e-4 of the largest |logit| or of
the loss (the reference's own mesh run is within ~1e-5 of its unsharded
one; in bfloat16 the two differ by ~3% whatever the mesh).  bfloat16
steps are held to the port unsharded within 1e-2.

``mamba_block(pcilt=, return_calib=True, ctx=)`` (mamba2-130m's smoke
layer, float32): the output within 2e-4 of its largest value, the conv
state, the saturation counters (count summed, ratio maxed over the rows
and channel shards) and the absmaxes exactly the unsharded block's, the
conv tables built per channel shard (no device holds them whole).
``convert_mamba_decode(ctx=)`` on placed parameters: the scales, tables
and CRC-32 records of the unsharded conversion byte for byte on a
data-parallel mesh; with a model axis the calibration's row-parallel
``wo`` and gated norm add their float32 partials in shard order, so its
absmaxes move by a few float32 ulps (held within 8 ulps) and the decode
is held to the unsharded conversion's within 2e-4 of its largest logit.
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
from repro_torch.core import pcilt_depthwise_conv1d
from repro_torch.core.serving import convert_mamba_decode
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (make_ctx, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import build_model as t_build
from repro_torch.nn import module as tmod
from repro_torch.nn import ssm
from repro_torch.nn.layers import dense
from test_torch_donor import jax_donor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-7b"
TOL, BF16_TOL, PCILT_TOL = 1e-4, 1e-2, 2e-4
B, T, S = 4, 16, 8
SHAPES = [(1, 2), (2, 2)]

#: the reference's own mesh run of the zamba2 smoke config: prefill,
#: decode (from the seeded cache) and loss on (1, 2) and (2, 2) ``Auto``
#: meshes
REF_MESH = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, "tests")
from test_torch_donor import jax_donor
from test_torch_hybrid_mesh import (SHAPES, config, inputs, jax_cache)
from repro.launch.steps import make_ctx, make_decode_step, make_prefill_step
from repro.models import build_model
from repro.nn.module import shardings

assert jax.device_count() >= 8, jax.device_count()
cfg = config("jax")
model = build_model(cfg)
specs = model.param_specs()
params = jax_donor(specs, 0)
cache, tok, tokens, labels = inputs(cfg)
out = {}
for shape in SHAPES:
    tag = f"{shape[0]}x{shape[1]}"
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pd = jax.device_put(params, shardings(specs, mesh))
    jc = jax_cache(model, cache)
    l, _ = jax.jit(make_decode_step(cfg, mesh))(pd, jc,
                                                jnp.asarray(tok, jnp.int32))
    out[tag + "|decode"] = np.asarray(l, np.float32)
    lp, _ = jax.jit(make_prefill_step(cfg, mesh))(
        pd, {"tokens": jnp.asarray(tokens)})
    out[tag + "|prefill"] = np.asarray(lp, np.float32)
    ctx = make_ctx(mesh)
    lv, met = jax.jit(lambda p, b: model.loss(p, b, ctx))(
        pd, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    out[tag + "|loss"] = np.asarray([lv, met["ce"], met["z"]], np.float32)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small (the steps run faster
    so), and the other test workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(pkg, dtype="float32"):
    """zamba2's smoke config cut to 4 layers (two segments: both shared
    sets run; each compiled reference step costs seconds), computing in
    ``dtype``."""
    cfg = (j_smoke if pkg == "jax" else t_smoke)(ARCH)
    return dataclasses.replace(cfg, n_layers=4, dtype=getattr(
        jnp if pkg == "jax" else torch, dtype))


def inputs(cfg):
    """The seeded decode cache (numpy, by leaf), the decode tokens, the
    prompt and the loss's labels."""
    rng = np.random.default_rng(7)
    specs = j_build(config("jax")).cache_specs(B, T)
    cache = {"attn/k": specs["attn"]["k"].shape,
             "attn/v": specs["attn"]["v"].shape,
             "ssm/conv": specs["ssm"]["layers"]["conv"].shape,
             "ssm/ssd": specs["ssm"]["layers"]["ssd"].shape}
    cache = {k: (0.5 * rng.normal(size=s)).astype(np.float32)
             for k, s in cache.items()}
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int64)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    return cache, tok, tokens, labels


def jax_cache(model, cache):
    """The reference's cache (its spec dtypes) holding the seeded values,
    ``pos`` = T - 3."""
    c = jax_donor(model.cache_specs(B, T), 1)
    c["attn"] = {n: jnp.asarray(cache[f"attn/{n}"]).astype(
        c["attn"][n].dtype) for n in ("k", "v")}
    c["ssm"] = {"layers": {n: jnp.asarray(cache[f"ssm/{n}"]).astype(
        c["ssm"]["layers"][n].dtype) for n in ("conv", "ssd")}}
    c["pos"] = jnp.asarray(T - 3, jnp.int32)
    return c


def port_cache(model, cache):
    c = tmod.materialize(model.cache_specs(B, T), 1, device="cpu")
    for n in ("k", "v"):
        c["attn"][n] = torch.from_numpy(cache[f"attn/{n}"]).to(
            c["attn"][n].dtype)
    for n in ("conv", "ssd"):
        c["ssm"]["layers"][n] = torch.from_numpy(cache[f"ssm/{n}"]).to(
            c["ssm"]["layers"][n].dtype)
    c["pos"] = T - 3
    return c


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "hybrid.npz"
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
def problem(ref_mesh):
    """The port's model and inputs, the reference's unsharded outputs
    (this process) and the port's unsharded ones."""
    jcfg, tcfg = config("jax"), config("torch")
    jm, tm = j_build(jcfg), t_build(tcfg)
    jparams = jax_donor(jm.param_specs(), 0)
    cache, tok, tokens, labels = inputs(tcfg)
    jl, _ = jax.jit(j_decode(jcfg, None))(jparams, jax_cache(jm, cache),
                                          jnp.asarray(tok, jnp.int32))
    jp, _ = jax.jit(j_prefill(jcfg, None))(jparams,
                                           {"tokens": jnp.asarray(tokens)})
    jv, jmet = jax.jit(lambda p, b: jm.loss(p, b, j_ctx(None)))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "labels": jnp.asarray(labels)})
    np_params = jax.tree.map(np.asarray, jparams)
    p = {"tm": tm, "tcfg": tcfg, "np_params": np_params, "cache": cache,
         "tok": torch.from_numpy(tok),
         "batch": {"tokens": torch.from_numpy(tokens)},
         "loss_batch": {"tokens": torch.from_numpy(tokens),
                        "labels": torch.from_numpy(labels)},
         "j_decode": np.asarray(jl, np.float32),
         "j_prefill": np.asarray(jp, np.float32),
         "j_loss": np.asarray([jv, jmet["ce"], jmet["z"]], np.float32)}
    whole = params_from_jax(np_params, "cpu")
    with torch.no_grad():
        p["t_decode"], p["t_dcache"] = make_decode_step(tcfg)(
            whole, port_cache(tm, cache), p["tok"])
        p["t_prefill"], p["t_pcache"] = make_prefill_step(tcfg)(
            whole, p["batch"])
        v, met = tm.loss(whole, p["loss_batch"])
        p["t_loss"] = np.asarray([float(v), float(met["ce"]),
                                  float(met["z"])], np.float32)
    return p


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _placed(p, shape):
    mesh = _mesh(shape)
    tm = p["tm"]
    params = params_from_jax(p["np_params"], shardings=tmod.shardings(
        tm.param_specs(), mesh))
    cache = tmod.place(port_cache(tm, p["cache"]),
                       tmod.shardings(tm.cache_specs(B, T), mesh))
    assert tmod.check_placed_bytes(params) > 0
    assert tmod.check_placed_bytes(cache) > 0
    return mesh, params, cache


def _close(got, want, scale, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float32)
                       - np.asarray(want, np.float32)).max())
    assert err <= tol * scale, (err, tol * scale)


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("mode", ["prefill", "decode", "loss"])
def test_hybrid_on_mesh_matches_three_references(problem, ref_mesh, shape,
                                                 mode):
    """``prefill`` (the last position's logits), ``decode_step`` (from the
    seeded cache at ``pos`` = T - 3) and ``loss`` (the loss, ce and z) on
    the mesh against the reference unsharded, the reference on the same
    ``Auto``-axes mesh and the port unsharded (float32 compute)."""
    p = problem
    mesh, params, cache = _placed(p, shape)
    with torch.no_grad():
        if mode == "prefill":
            got, _ = make_prefill_step(p["tcfg"], mesh)(params, p["batch"])
        elif mode == "decode":
            got, _ = make_decode_step(p["tcfg"], mesh)(params, cache,
                                                       p["tok"])
        else:
            v, met = p["tm"].loss(params, p["loss_batch"],
                                  ctx=make_ctx(mesh))
            got = torch.tensor([float(v), float(met["ce"]),
                                float(met["z"])])
    got = got.float().numpy()
    scale = float(np.abs(p[f"j_{mode}"]).max())
    _close(got, p[f"j_{mode}"], scale)
    _close(got, ref_mesh[f"{_tag(shape)}|{mode}"], scale)
    _close(got, p[f"t_{mode}"], scale)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_hybrid_caches_come_back_placed(problem, shape):
    """A prefill's and a step's caches: the K/V ``[n_apps, B, T, Hk, Dh]``
    and the SSM states placed by the cache rules (the batch over
    ``"data"``, the KV heads and SSD heads over ``"model"``), joined equal
    to the port's unsharded caches (K/V within one bfloat16 step, the SSM
    states within 1e-4 of their largest), ``pos`` the unsharded one's."""
    p = problem
    mesh, params, cache = _placed(p, shape)
    with torch.no_grad():
        _, pc = make_prefill_step(p["tcfg"], mesh)(params, p["batch"])
        _, dc = make_decode_step(p["tcfg"], mesh)(params, cache, p["tok"])
    want = tmod.shardings(p["tm"].cache_specs(B, T), mesh)
    for got, ref in ((pc, p["t_pcache"]), (dc, p["t_dcache"])):
        assert got["pos"] == ref["pos"]
        for n in ("k", "v"):
            k = got["attn"][n]
            assert isinstance(k, tmod.Placed)
            assert k.spec[3] == want["attn"][n].spec[3]
            a, b = k.join().float(), ref["attn"][n].float()
            assert bool(((a - b).abs() <= b.abs() * 2 ** -7).all())
        for n in ("conv", "ssd"):
            st = got["ssm"]["layers"][n]
            assert isinstance(st, tmod.Placed)
            ref_n = ref["ssm"]["layers"][n]
            _close(st.join().numpy(), ref_n.numpy(),
                   max(float(ref_n.abs().max()), 1.0))
    assert dc["ssm"]["layers"]["ssd"].spec == \
        want["ssm"]["layers"]["ssd"].spec


@pytest.mark.parametrize("shape", SHAPES + [(1, 4)], ids=_tag)
def test_hybrid_bf16_steps_match_unsharded(problem, shape):
    """bfloat16 compute: the mesh's prefill, decode step and loss against
    the port's unsharded ones, 1e-2 of the largest |logit| (of the
    loss)."""
    p = problem
    tcfg = config("torch", "bfloat16")
    whole = params_from_jax(p["np_params"], "cpu")
    mesh, params, cache = _placed(p, shape)
    with torch.no_grad():
        want = make_prefill_step(tcfg)(whole, p["batch"])[0]
        got = make_prefill_step(tcfg, mesh)(params, p["batch"])[0]
        assert got.dtype == torch.bfloat16
        _close(got.float(), want.float(), float(want.float().abs().max()),
               BF16_TOL)
        want = make_decode_step(tcfg)(whole, port_cache(p["tm"], p["cache"]),
                                      p["tok"])[0]
        got = make_decode_step(tcfg, mesh)(params, cache, p["tok"])[0]
        _close(got.float(), want.float(), float(want.float().abs().max()),
               BF16_TOL)
        tm = t_build(tcfg)
        want = float(tm.loss(whole, p["loss_batch"])[0])
        got = float(tm.loss(params, p["loss_batch"], ctx=make_ctx(mesh))[0])
        _close(got, want, abs(want), BF16_TOL)


def test_hybrid_engine_still_refused_on_mesh():
    """The ``Engine`` refuses the family on a mesh as without one: the
    reference's engine fails on it (ROADMAP Queue 3)."""
    from repro_torch.launch.serve import Engine

    with pytest.raises(NotImplementedError, match="hybrid"):
        Engine(t_smoke(ARCH), 64, 2, _mesh((1, 2)), device="cpu")


# ----------------------------------------------------------------------------
# the Mamba block's PCILT conv and calibration under a ctx
# ----------------------------------------------------------------------------


MAMBA_SHAPES = [(2, 1), (1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module")
def mamba():
    cfg = dataclasses.replace(t_smoke("mamba2-130m"),
                              pcilt=TPCILT(act_bits=2, group=2),
                              dtype=torch.float32)
    m = t_build(cfg)
    params = tmod.materialize(m.param_specs(), 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, T)))
    return {"cfg": cfg, "m": m, "params": params, "x": x, "calib": calib}


@pytest.mark.parametrize("shape", MAMBA_SHAPES, ids=_tag)
def test_mamba_block_pcilt_and_calib_under_ctx(mamba, shape):
    """``mamba_block(pcilt=, return_state=True, return_calib=True, ctx=)``:
    the conv tables built per channel shard by ``build_pcilt_conv`` on the
    placed ``conv_w`` (each device holds its block only; joined, the
    unsharded tables bit for bit), the output within 2e-4 of its largest,
    the conv state exact, the absmaxes exact, and the full-sequence conv's
    saturation counters (count summed over the rows and channel shards,
    ratio their max) those of the unsharded signal, exactly."""
    cfg, m = mamba["cfg"], mamba["m"]
    p0 = tmod.layer_view(mamba["params"]["blocks"], 0)["mixer"]
    x = mamba["x"]
    with torch.no_grad():
        _, cal = ssm.mamba_block(p0, cfg, x, return_calib=True)
        scale = float(cal["conv_in"]) / 2  # a grid that saturates
        pc = ssm.build_pcilt_conv(p0, cfg, scale)
        want, wst, wcal = ssm.mamba_block(p0, cfg, x, return_state=True,
                                          pcilt=pc, return_calib=True)
        xbc = torch.cat([dense(p0[n], x, cfg.dtype)
                         for n in ("wx", "wB", "wC")], -1)
        _, wcount, wratio = pcilt_depthwise_conv1d(
            xbc, p0["conv_w"], pc["spec"], scale, tables=pc["tables"],
            path="fused", padding="CAUSAL", return_stats=True)
        mesh = _mesh(shape)
        ctx = make_ctx(mesh)
        placed = tmod.place(mamba["params"], tmod.shardings(
            m.param_specs(), mesh))
        q0 = tmod.layer_view(placed["blocks"], 0)["mixer"]
        pcp = ssm.build_pcilt_conv(q0, cfg, scale)
        tabs = pcp["tables"]
        assert isinstance(tabs, tmod.Placed)
        n = ctx.splits(q0["conv_w"], 1)
        assert all(t.shape[0] == tabs.shape[0] // n
                   for t in tabs.blocks.values())
        assert torch.equal(tabs.join(), pc["tables"])
        xs = ctx.split_rows(x)
        got, gst, gcal = ssm.mamba_block(q0, cfg, xs, return_state=True,
                                         pcilt=pcp, return_calib=True,
                                         ctx=ctx)
        _, _, stats, _ = ssm._mamba_mesh(q0, cfg, ctx, xs, pcilt=pcp)
    got = ctx.join_rows(got)
    _close(got.numpy(), want.numpy(), float(want.abs().max()), PCILT_TOL)
    assert torch.equal(tmod.join(gst["conv"]), wst["conv"])
    for k in ("conv_in", "wo_in"):
        assert torch.equal(gcal[k], wcal[k]), k
    count, ratio = stats["conv"]
    assert int(wcount) > 0
    assert int(count) == int(wcount) and float(ratio) == float(wratio)


@pytest.mark.parametrize("shape", MAMBA_SHAPES, ids=_tag)
def test_convert_mamba_decode_calibrates_under_ctx(mamba, shape):
    """``convert_mamba_decode(..., ctx=)`` on placed parameters calibrates
    through the per-shard bodies (never a joined tree).  On a
    data-parallel mesh its scales, tables and CRC-32 records are the
    unsharded conversion's byte for byte; with a model axis the
    absmaxes move by at most 8 float32 ulps (the row-parallel partial
    sums) and a decode step is within 2e-4 of the unsharded conversion's
    largest logit, its counters equal."""
    cfg, m = mamba["cfg"], mamba["m"]
    mesh = _mesh(shape)
    ctx = make_ctx(mesh, None, decode=True)
    placed = tmod.place(mamba["params"], tmod.shardings(m.param_specs(),
                                                        mesh))
    calls = []
    real = m.calibrate_pcilt

    def spy(params, batch, *, ctx=None):
        calls.append(isinstance(params["embed"]["embedding"], tmod.Placed)
                     and ctx is not None)
        return real(params, batch, ctx=ctx)

    m.calibrate_pcilt = spy
    try:
        with torch.no_grad():
            whole = convert_mamba_decode(m, mamba["params"], mamba["calib"],
                                         paired=True, head="shared",
                                         device="cpu")
            dec = convert_mamba_decode(m, placed, mamba["calib"], ctx=ctx,
                                       paired=True, head="shared",
                                       device="cpu")
    finally:
        del m.calibrate_pcilt
    assert calls == [False, True]
    assert dec.ctx is ctx
    ws, gs = whole.pcilt["proj"]["scales"], dec.pcilt["proj"]["scales"]
    if shape[1] == 1:
        for k in ws:
            assert torch.equal(gs[k], ws[k]), k
        assert dec.pcilt["scale"] == whole.pcilt["scale"]
        assert dec.pcilt["integrity"] == whole.pcilt["integrity"]
    else:
        for k in ws:
            np.testing.assert_allclose(gs[k].numpy(), ws[k].numpy(),
                                       rtol=8 * 2 ** -23, atol=0)
    rng = np.random.default_rng(5)
    cache = tmod.materialize(m.cache_specs(B), 5, device="cpu")
    for t in cache["layers"].values():
        t.copy_(torch.from_numpy(0.1 * rng.normal(size=tuple(t.shape))
                                 .astype(np.float32)))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))
    pc = tmod.place(cache, tmod.shardings(m.cache_specs(B), mesh))
    with torch.no_grad():
        want, _, ws_ = whole.step(mamba["params"], cache, tok,
                                  with_stats=True)
        got, _, gs_ = dec.step(placed, pc, tok, with_stats=True)
    _close(got.numpy(), want.numpy(), float(want.abs().max()), PCILT_TOL)
    for g in ("in", "conv", "out"):
        assert torch.equal(gs_[g]["count"], ws_[g]["count"]), g
