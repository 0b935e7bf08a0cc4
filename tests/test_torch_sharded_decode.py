"""Port parity: the converted Mamba decode with its projection stacks
sharded over a CPU mesh (D in {2, 4}, and 3, which replicates).

* ``convert_mamba_decode(..., mesh=)`` and ``MambaLM.build_pcilt(mesh=)``
  build each projection stack straight into its shards
  (``core.pcilt.ShardedTables``: ``[L, G/D, V, O]`` blocks of the 4-bit
  stacks, ``[G2/D, L, V2, O]`` of the paired ones), joined byte-equal to
  the JAX package's stacks, with its integrity record byte for byte;
* a sharded step against the JAX package's unsharded step in this process
  (the reference's sharded-decode tolerance, rtol = atol = 2e-4, on the
  logits and the SSD state; argmax equal but at exact ties of the
  coarse-grid head logits) and against the JAX package's own sharded
  decode, run by a module-scoped fixture in a subprocess with 8 forced
  host devices (2e-4), the stats counters exact;
* the local-shard design-cache keys of ``PCILTMambaDecode.tune``;
* the health monitor on a sharded bundle: a flipped entry of one shard is
  found at its layer, demotion, the recalibration writing each shard's
  block (equal, joined, to the unsharded recalibration, the record
  re-chained), and an ``Engine`` serving a sharded bundle through the
  ``--chaos`` plan's table fault (one shard flipped in place) with the
  fault-free run's undegraded tokens.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.core import serving as js
from repro.models import build_model as j_build
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.core import pcilt as tp
from repro_torch.core import serving as ts
from repro_torch.interop import bundle_from_jax, params_from_jax
from repro_torch.kernels import autotune as atn
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build
from repro_torch.nn.ssm import PROJ_NAMES
from repro_torch.runtime import FaultInjector
from test_torch_donor import jax_donor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # the reference's sharded-decode tolerance
B = 2
#: the two decode configurations: 4-bit unpaired, and paired at 2 bits
KINDS = {"4bit": (4, False), "paired": (2, True)}

#: the JAX package's sharded decode, in a process of its own with 8 forced
#: host devices: the smoke mamba2 on the seeded donor, converted with
#: ``mesh=make_decode_mesh(D)``, one step from a seeded cache
JAX_SHARDED_DECODE = r'''
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, "tests")
from test_torch_donor import jax_donor
from repro.configs import get_smoke_config
from repro.configs.base import PCILTConfig
from repro.core.serving import convert_mamba_decode
from repro.launch.mesh import make_decode_mesh
from repro.models import build_model

assert jax.device_count() >= 8, jax.device_count()
out = {}
for tag, bits, paired in (("4bit", 4, False), ("paired", 2, True)):
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=bits, group=2),
                              dtype=jnp.float32)
    model = build_model(cfg)
    params = jax_donor(model.param_specs(), 0)
    calib = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    rng = np.random.default_rng(5)
    specs = model.cache_specs(2, 16)["layers"]
    cache = {"layers": {k: jnp.asarray((0.1 * rng.normal(size=s.shape))
                                       .astype(np.float32))
                        for k, s in specs.items()},
             "pos": jnp.asarray(16, jnp.int32)}
    tok = jnp.asarray(rng.integers(0, cfg.vocab, (2, 1)), jnp.int32)
    for D in (2, 4):
        dec = convert_mamba_decode(model, params, jnp.asarray(calib),
                                   mesh=make_decode_mesh(D), paired=paired,
                                   head="shared")
        logits, nc, sat = dec.step(params, cache, tok, with_stats=True)
        out[f"{tag}_logits_{D}"] = np.asarray(logits)
        out[f"{tag}_ssd_{D}"] = np.asarray(nc["layers"]["ssd"])
        for g in ("in", "conv", "out"):
            out[f"{tag}_count_{g}_{D}"] = np.asarray(sat[g]["count"])
        for name, t in dec.pcilt["proj"]["tables"].items():
            out[f"{tag}_proj_{name}_{D}"] = np.asarray(t)
np.savez(sys.argv[1], **out)
'''


def _mesh(D):
    return tmesh.make_decode_mesh(D, devices=["cpu"] * D)


def _cache(model, seed=5):
    """The seeded decode cache of the JAX run (numpy)."""
    rng = np.random.default_rng(seed)
    specs = model.cache_specs(B, 16)["layers"]
    layers = {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
              for k, s in specs.items()}
    return layers, rng.integers(0, model.cfg.vocab, (B, 1))


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """Per configuration: the JAX model, the seeded donor, its unsharded
    conversion and one step from the seeded cache; the port's model and
    parameters."""
    from repro.kernels import autotune as jatn

    jatn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    out = {}
    for kind, (bits, paired) in KINDS.items():
        jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                                   pcilt=JPCILT(act_bits=bits, group=2),
                                   dtype=jnp.float32)
        tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                                   pcilt=TPCILT(act_bits=bits, group=2),
                                   dtype=torch.float32)
        jmodel = j_build(jcfg)
        jparams = jax_donor(jmodel.param_specs(), 0)
        calib = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16))
        jdec = js.convert_mamba_decode(jmodel, jparams, jnp.asarray(calib),
                                       paired=paired, head="shared")
        layers, tok = _cache(jmodel)
        jcache = {"layers": {k: jnp.asarray(v) for k, v in layers.items()},
                  "pos": jnp.asarray(16, jnp.int32)}
        wl, wc, wsat = jdec.step(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                 with_stats=True)
        out[kind] = {
            "tcfg": tcfg, "paired": paired, "calib": calib, "jdec": jdec,
            "layers": layers, "tok": tok, "want": np.asarray(wl),
            "want_ssd": np.asarray(wc["layers"]["ssd"]),
            "want_sat": jax.tree.map(np.asarray, wsat),
            "tmodel": t_build(tcfg),
            "tparams": params_from_jax(jax.tree.map(np.asarray, jparams),
                                       "cpu")}
    yield out
    jatn.reset_cache()


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's own sharded decode (outputs and joined stacks)."""
    d = tmp_path_factory.mktemp("jax_sharded_decode")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["REPRO_PCILT_TUNE_CACHE"] = str(d / "tiles.json")
    r = subprocess.run([sys.executable, "-c", JAX_SHARDED_DECODE,
                        str(d / "out.npz")], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"the JAX sharded decode failed:\n{r.stderr}"
    return dict(np.load(d / "out.npz"))


def _step(dec, p, with_stats=False):
    cache = {"layers": {k: torch.from_numpy(v.copy())
                        for k, v in p["layers"].items()}}
    return dec.step(p["tparams"], cache, torch.from_numpy(p["tok"]),
                    with_stats=with_stats)


def _logits_close(got, want):
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
        # only at a tie of the coarse-grid head logits
        assert got[b, want[b].argmax()] >= got[b].max() - TOL


def _sharded_bundle(p, D):
    return bundle_from_jax(p["jdec"].pcilt, "cpu", mesh=_mesh(D))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_build_and_record_match_reference(problems, kind, D):
    """``build_pcilt(mesh=)`` with the reference's scales: every
    projection stack sharded on its segment axis, joined byte-equal to the
    reference's stack; the integrity record the reference's; the head and
    conv tables whole; the per-device bytes a D-th."""
    p = problems[kind]
    jb = p["jdec"].pcilt
    proj = jb["proj"]
    got = p["tmodel"].build_pcilt(
        p["tparams"], np.asarray(jb["scale"]),
        proj_scales={"in": np.asarray(proj["scales"]["wx"]),
                     "out": np.asarray(proj["scales"]["wo"])},
        head_scale=np.asarray(jb["head"]["scale"]), paired=p["paired"],
        mesh=_mesh(D))
    seg_axis = 0 if p["paired"] else 1
    for name in PROJ_NAMES:
        t = got["proj"]["tables"][name]
        want = np.asarray(proj["tables"][name])
        assert isinstance(t, tp.ShardedTables) and t.n_shards == D
        assert t.seg_axis == seg_axis and tuple(t.shape) == want.shape
        assert t.shards[0].shape[seg_axis] * D == want.shape[seg_axis]
        assert t.per_device_bytes() * D == want.nbytes
        np.testing.assert_array_equal(t.materialize().numpy(), want,
                                      err_msg=name)
    assert torch.is_tensor(got["tables"]) and torch.is_tensor(
        got["head"]["pool"])
    assert got["integrity"] == jb["integrity"]
    dec = ts.PCILTMambaDecode(p["tmodel"], got)
    assert dec.verify_integrity() == []
    assert dec.table_bytes() == p["jdec"].table_bytes()


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_step_matches_reference(problems, kind, D):
    """One step of the reference's bundle, sharded over the mesh, against
    the JAX package's unsharded step: logits and SSD state within 2e-4,
    the saturation counters exact (one pass over each projection's whole
    input, not one a shard)."""
    p = problems[kind]
    dec = ts.PCILTMambaDecode(p["tmodel"], _sharded_bundle(p, D))
    tops.reset_launches()
    logits, cache, sat = _step(dec, p, with_stats=True)
    assert not any(tops.LAUNCHES.values())  # plain versions on the CPU
    _logits_close(logits, p["want"])
    np.testing.assert_allclose(cache["layers"]["ssd"].numpy(), p["want_ssd"],
                               rtol=TOL, atol=TOL)
    for g in ("in", "conv", "out"):
        np.testing.assert_array_equal(sat[g]["count"].numpy(),
                                      p["want_sat"][g]["count"])


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_step_matches_jax_sharded(problems, jax_sharded, kind, D):
    """The port's own conversion with ``mesh=`` against the JAX package's
    sharded conversion and step (8 forced host devices): the same stacks
    byte for byte, logits and state within 2e-4, counters exact."""
    p = problems[kind]
    j = jax_sharded
    dec = ts.convert_mamba_decode(p["tmodel"], p["tparams"],
                                  torch.from_numpy(p["calib"]),
                                  mesh=_mesh(D), paired=p["paired"],
                                  head="shared", device="cpu")
    for name, t in dec.pcilt["proj"]["tables"].items():
        assert isinstance(t, tp.ShardedTables)
        np.testing.assert_allclose(t.materialize().numpy(),
                                   j[f"{kind}_proj_{name}_{D}"], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    logits, cache, sat = _step(dec, p, with_stats=True)
    _logits_close(logits, j[f"{kind}_logits_{D}"])
    np.testing.assert_allclose(cache["layers"]["ssd"].numpy(),
                               j[f"{kind}_ssd_{D}"], rtol=TOL, atol=TOL)
    for g in ("in", "conv", "out"):
        np.testing.assert_array_equal(sat[g]["count"].numpy(),
                                      j[f"{kind}_count_{g}_{D}"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_three_way_mesh_replicates(problems, kind):
    """A model axis of 3 divides no segment count of the smoke config: the
    conversion keeps whole stacks and the step is the unsharded one, bit
    for bit."""
    p = problems[kind]
    kw = dict(paired=p["paired"], head="shared", device="cpu")
    calib = torch.from_numpy(p["calib"])
    rep = ts.convert_mamba_decode(p["tmodel"], p["tparams"], calib,
                                  mesh=_mesh(3), **kw)
    ref = ts.convert_mamba_decode(p["tmodel"], p["tparams"], calib, **kw)
    assert all(torch.is_tensor(t)
               for t in rep.pcilt["proj"]["tables"].values())
    assert rep.pcilt["integrity"] == ref.pcilt["integrity"]
    assert torch.equal(_step(rep, p)[0], _step(ref, p)[0])


@pytest.mark.parametrize("kind", list(KINDS))
def test_tune_keys_the_local_shard(problems, kind, tmp_path):
    """``PCILTMambaDecode.tune`` under a 2- and a 4-way mesh records the
    stacked kernels' keys at the local G (G/D, G2/D), never the global
    one."""
    p = problems[kind]
    path = str(tmp_path / "tiles.json")
    atn.reset_cache(path)
    name = "fused_gemv_paired_stacked|" if p["paired"] else \
        "fused_gemv_stacked|"
    seg_axis = 0 if p["paired"] else 1
    #: each projection's (segment count, outputs)
    shapes = {(t.shape[seg_axis], t.shape[-1])
              for t in p["jdec"].pcilt["proj"]["tables"].values()}

    def timer(fn, reps, warmup):
        fn()
        return 1.0

    try:
        with atn.using_timer(timer):
            for D in (2, 4):
                ts.PCILTMambaDecode(p["tmodel"],
                                    _sharded_bundle(p, D)).tune(batch=1)
        dims = [dict(kv.split("=") for kv in k.split("|")[1].split(","))
                for k in json.load(open(path)) if k.startswith(name)]
        got = {(int(d["G"]), int(d["O"])) for d in dims}
        assert got == {(G // D, O) for G, O in shapes for D in (2, 4)}, got
    finally:
        atn.reset_cache(str(tmp_path / "after.json"))


@pytest.mark.parametrize("kind", list(KINDS))
def test_monitor_finds_and_recalibrates_a_shard(problems, kind):
    """The monitor on a 4-way sharded bundle: a flipped entry of one shard
    (``FaultInjector.corrupt_table``, in place) is found at its layer and
    nowhere else; a recalibration writes each shard's block of the layer on
    its device, equal (joined) to the unsharded recalibration, the record
    re-chained to the unsharded one's."""
    p = problems[kind]
    axis = 1 if p["paired"] else 0
    sharded = ts.PCILTMambaDecode(p["tmodel"], _sharded_bundle(p, 4))
    whole = ts.PCILTMambaDecode(p["tmodel"],
                                bundle_from_jax(p["jdec"].pcilt, "cpu"))
    inj = FaultInjector(seed=3)
    t = sharded.pcilt["proj"]["tables"]["wx"]
    before = [s.clone() for s in t.shards]
    assert inj.corrupt_table(t, n_flips=1) is t
    ev = inj.events[-1]
    d = ev["shard"]
    assert all(torch.equal(a, b) == (i != d)
               for i, (a, b) in enumerate(zip(before, t.shards)))
    layer = ev["sites"][0][axis]
    L = p["tcfg"].n_layers
    assert [sharded.verify_layer(l) for l in range(L)] == [
        [("wx", layer)] if l == layer else [] for l in range(L)]
    mon = ts.HealthMonitor(sharded, p["tparams"], oracle_every=0)
    evs = mon.on_tick(layer)
    assert [e["kind"] for e in evs] == ["layer"] and \
        evs[0]["layer"] == layer and not mon.layer_ok[layer]
    # a clean copy, then the recalibration on both layouts
    for s, b in zip(t.shards, before):
        s.copy_(b)
    assert sharded.verify_integrity() == []
    mons = [ts.HealthMonitor(dec, p["tparams"], oracle_every=0)
            for dec in (sharded, whole)]
    for m in mons:
        m.sat_peak["in"][1] = 1.5
        m.layer_ok[1] = False
        ev = m.recalibrate_layer(1, "in", tick=9)
        assert ev["kind"] == "recalibrate" and m.layer_ok[1]
    for name in PROJ_NAMES:
        a = sharded.pcilt["proj"]["tables"][name]
        b = whole.pcilt["proj"]["tables"][name]
        assert torch.equal(a.materialize(), b), name
    assert sharded.pcilt["integrity"] == whole.pcilt["integrity"]
    assert sharded.verify_integrity() == []


def test_engine_serves_a_sharded_bundle_through_the_chaos_table_fault(
        problems):
    """``Engine(pcilt_bundle=)`` with 4-way sharded stacks under its
    monitor: fault-free, the unsharded bundle's tokens; with the
    ``--chaos`` plan's table fault (two entries of one ``wx`` shard flipped
    in place at step 15) the breach is found and the layer demoted, no
    request is lost, and every undegraded request keeps the fault-free
    tokens, as with the unsharded bundle."""
    p = problems["4bit"]
    cfg = p["tcfg"]

    def serve(bundle, fault):
        eng = tserve.Engine(cfg, max_len=64, slots=2, pcilt=True,
                            params=p["tparams"], pcilt_bundle=bundle,
                            device="cpu")
        injector = FaultInjector(seed=1)
        if fault:
            eng.chaos = {15: tserve._chaos_plan(eng, injector)[15]}
        reqs = tserve.make_requests(cfg, 3, 8, 1)
        eng.run(reqs)
        return eng, reqs, injector

    clean, ref, _ = serve(bundle_from_jax(p["jdec"].pcilt, "cpu"), False)
    _, shard_reqs, _ = serve(_sharded_bundle(p, 4), False)
    assert [r.out for r in shard_reqs] == [r.out for r in ref]
    for bundle in (_sharded_bundle(p, 4),
                   bundle_from_jax(p["jdec"].pcilt, "cpu")):
        eng, reqs, injector = serve(bundle, True)
        assert [e["kind"] for e in injector.events] == ["table_corruption"]
        assert ("shard" in injector.events[0]) == isinstance(
            bundle["proj"]["tables"]["wx"], tp.ShardedTables)
        breaches = [e for e in eng.monitor.events if e["kind"] == "layer"]
        assert breaches and "checksum breach" in breaches[0]["reason"]
        assert all(r.outcome in ("served", "degraded") for r in reqs)
        assert all(r.out == q.out for r, q in zip(reqs, ref)
                   if r.outcome == "served")
