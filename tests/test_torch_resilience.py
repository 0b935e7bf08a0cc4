"""Port parity of the serving resilience layer: the port's ``Engine`` with
its ``HealthMonitor`` on the CPU, given the JAX engine's parameters and
converted bundle through the bridge, goes through the ``--chaos`` fault
plan exactly as the JAX ``Engine`` does.

The plans are the ``--chaos`` plan's actions (a scheduled step fault, NaN
state, two flipped entries of the ``wx`` stack, a re-aimed head pointer)
at their steps 7, 11, 15 and 19, and re-keyed to later steps so that some
requests finish before the first breach.  (The reference's plan also
garbles its autotune cache at step 4, which changes no engine state; the
port has no autotune cache, so that action is left out of both runs.)
Both engines must give the same per-request outcomes, the same health
events (kind, layer, tick, reason), the same restarts and rollbacks, the
same injected faults and the same tokens.

Every step is compared as ``tests/test_torch_serve.py`` compares it: the
port is fed the same tokens, its logits agree with the reference's to
1e-4 (the demoted steps run the dense oracle: float32 matmuls summed in
another order), and a greedy token may differ only at an exact tie of the
coarse-grid head logits, where the reference's is fed on to both.  A
step whose state was poisoned is not compared (NaN becomes an integer
code by no defined rule); both engines must refuse to commit it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.launch import serve as js
from repro.runtime.faults import FaultInjector as JInjector
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.interop import bundle_from_jax, params_from_jax
from repro_torch.launch import serve as ts
from repro_torch.nn.module import materialize
from repro_torch.runtime import FaultInjector
from test_torch_donor import hash_free_engines

SLOTS, N_REQ, SEED = 2, 3, 1
TOL = 1e-4
#: plan -> (the chaos plan's step keys, new tokens a request): as the CLI
#: schedules them, and with the table faults late and longer requests, so
#: that two requests finish undegraded before the breach
PLANS = {"cli": ({7: 7, 11: 11, 15: 15, 19: 19}, 4),
         "late": ({7: 7, 11: 11, 15: 40, 19: 46}, 10)}


def _copy_bundle(obj):
    """Nested dict/list copy, arrays shared (the reference's chaos plan
    replaces entries, never mutates arrays)."""
    if isinstance(obj, dict):
        return {k: _copy_bundle(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy_bundle(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                               pcilt=JPCILT(act_bits=4, group=2),
                               dtype=jnp.float32)
    with hash_free_engines():  # weights independent of PYTHONHASHSEED
        jeng = js.Engine(jcfg, max_len=64, slots=SLOTS, pcilt=True)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=4, group=2),
                               dtype=torch.float32)
    yield {"jcfg": jcfg, "tcfg": tcfg, "jeng": jeng,
           "params": jax.tree.map(np.asarray, jeng.params)}
    atn.reset_cache()


def _rekey(plan, keys):
    return {keys[k]: v for k, v in plan.items() if k in keys}


def _port_engine(donor, **kw):
    """A port engine on the donor's weights and its own copy of the
    donor's (clean) tables."""
    return ts.Engine(donor["tcfg"], slots=SLOTS, pcilt=True, device="cpu",
                     params=params_from_jax(donor["params"], "cpu"),
                     pcilt_bundle=bundle_from_jax(donor["jeng"].pdecode.pcilt,
                                                  "cpu"), **kw)


@pytest.fixture(scope="module", params=sorted(PLANS))
def chaos_pair(request, donor):
    """The JAX engine's chaos run (its tokens fed and logits recorded at
    every step), then the port's, compared step by step."""
    keys, max_new = PLANS[request.param]
    with hash_free_engines():
        jeng = js.Engine(donor["jcfg"], max_len=64, slots=SLOTS, pcilt=True,
                         pcilt_bundle=_copy_bundle(
                             donor["jeng"].pdecode.pcilt))
    jinj = JInjector(fail_at=(7,), seed=SEED)
    jeng.chaos = _rekey(js._chaos_plan(jeng, jinj), keys)
    log = []
    raw = jeng._raw_step

    def logged():
        finite = all(bool(jnp.all(jnp.isfinite(a)))
                     for a in jax.tree.leaves(jeng.cache["layers"]))
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits), finite))
        return logits, cache

    jeng._raw_step = logged
    jreqs = js._make_requests(donor["jcfg"], N_REQ, max_new, None, SEED)
    jstats = jeng.run(jreqs)

    teng = _port_engine(donor)
    tinj = FaultInjector(fail_at=(7,), seed=SEED)
    teng.chaos = _rekey(ts._chaos_plan(teng, tinj), keys)
    seen = {"steps": 0, "ties": 0, "poisoned": 0}
    traw = teng._raw_step

    def compared():
        fed, want, finite = log[seen["steps"]]
        seen["steps"] += 1
        np.testing.assert_array_equal(teng.tokens, fed)
        assert finite == all(bool(torch.isfinite(t).all())
                             for t in teng.cache["layers"].values())
        logits, cache = traw()
        if not finite:
            seen["poisoned"] += 1
            return logits, cache
        got = logits.numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
            assert got[b, want[b].argmax()] >= got[b].max() - TOL, \
                f"step {seen['steps']} row {b}: not a tie"
            seen["ties"] += 1
        return torch.from_numpy(want.copy()), cache

    teng._raw_step = compared
    treqs = ts.make_requests(donor["tcfg"], N_REQ, max_new, SEED)
    tstats = teng.run(treqs)
    return dict(plan=request.param, jeng=jeng, jreqs=jreqs, jstats=jstats,
                jinj=jinj, teng=teng, treqs=treqs, tstats=tstats, tinj=tinj,
                seen=seen, log=log)


def _events(stats):
    return [(e["kind"], e["layer"], e["tick"], e["reason"])
            for e in stats["health_events"]]


def test_same_steps_and_injected_faults(chaos_pair):
    p = chaos_pair
    assert p["seen"]["steps"] == len(p["log"])
    assert p["seen"]["poisoned"] == 1  # the NaN step, refused by both
    assert p["tinj"].events == p["jinj"].events
    assert [e["kind"] for e in p["tinj"].events] == [
        "step_fault", "activation_poison", "table_corruption",
        "seg_idx_flip"]
    assert not p["teng"].chaos and not p["jeng"].chaos  # every fault fired
    assert p["teng"].steps == p["jeng"].steps


def test_same_outcomes_events_restarts_rollbacks(chaos_pair):
    p = chaos_pair
    t, j = p["tstats"], p["jstats"]
    assert t["outcomes"] == j["outcomes"]
    assert _events(t) == _events(j)
    kinds = {e[0] for e in _events(t)}
    assert {"layer", "head"} <= kinds  # the wx flip and the head pointer
    for key in ("restarts", "rollbacks", "decode_ticks", "prefill_ticks",
                "served", "degraded", "failed", "rejected", "retried",
                "table_bytes"):
        assert t[key] == j[key], key
    assert t["restarts"] == 2 and t["rollbacks"] >= 1
    assert list(p["teng"].monitor.layer_ok) == list(p["jeng"].monitor.layer_ok)
    assert p["teng"].monitor.head_ok == p["jeng"].monitor.head_ok
    np.testing.assert_array_equal(p["teng"].monitor.last_verified,
                                  p["jeng"].monitor.last_verified)


def test_same_tokens_and_undegraded_requests(chaos_pair):
    p = chaos_pair
    assert [r.out for r in p["treqs"]] == [r.out for r in p["jreqs"]]
    assert [r.outcome for r in p["treqs"]] == [r.outcome for r in p["jreqs"]]
    assert all(r.outcome in ("served", "degraded") and r.done
               for r in p["treqs"])
    if p["plan"] == "late":  # two requests finish before the first breach
        assert [r.outcome for r in p["treqs"]].count("served") == 2


def test_cli_chaos_contract_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --pcilt --chaos --device cpu``:
    the port's own contract (no request lost, undegraded tokens equal to a
    fault-free run, the demoted step equal to the dense oracle) holds."""
    ts.main(["--arch", "mamba2-130m", "--pcilt", "--chaos", "--device",
             "cpu"])
    out = capsys.readouterr().out
    assert "chaos contract verified: 6 requests completed" in out


def test_cli_chaos_step4_quarantines_the_design_cache(capsys, tmp_path,
                                                     monkeypatch):
    """Step 4 of the ``--chaos`` plan garbles the design cache's file: the
    reload warns and quarantines it (the bytes kept), the cache goes on
    empty, and the contract still holds."""
    import os

    from repro_torch.kernels import autotune as atn

    path = str(tmp_path / "tiles.json")
    monkeypatch.setenv("REPRO_PCILT_TUNE_CACHE", path)
    atn.reset_cache()
    try:
        ts.main(["--arch", "mamba2-130m", "--pcilt", "--chaos", "--device",
                 "cpu"])
        out = capsys.readouterr().out
        assert "chaos contract verified: 6 requests completed" in out
        assert "5 faults injected" in out
        q = [n for n in os.listdir(tmp_path)
             if n.startswith("tiles.json.corrupt-")]
        assert len(q) == 1
        assert open(tmp_path / q[0], "rb").read().startswith(b'{"tiles": tru')
        assert atn.get_cache().path == path
        assert "chaos_probe|B=1,dtype=float32|backend=cpu" not in \
            atn.get_cache().entries()
    finally:
        atn.reset_cache(str(tmp_path / "after.json"))


def test_demoted_step_equals_dense_oracle(chaos_pair, donor):
    """Every layer and the head demoted: the port's step equals the dense
    fake-quant oracle (1e-4) and the reference's demoted step on the same
    state and tokens."""
    teng = chaos_pair["teng"]
    cfg = donor["tcfg"]
    cache = materialize(teng.model.cache_specs(SLOTS), 5, device="cpu")
    rng = np.random.default_rng(5)
    for t in cache["layers"].values():
        t.copy_(torch.from_numpy(
            0.1 * rng.normal(size=tuple(t.shape)).astype(np.float32)))
    tok = torch.full((SLOTS, 1), 3, dtype=torch.int64)
    bundle = teng.pdecode.pcilt
    with torch.no_grad():
        got, _ = teng.pdecode.step(teng.params, cache, tok,
                                   layer_ok=[False] * cfg.n_layers,
                                   head_ok=False)
        fq = dict(bundle, proj=dict(bundle["proj"], path="dense_fq"))
        want, _ = teng.model.decode_step(teng.params, cache, tok, pcilt=fq,
                                         head_ok=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    jeng = chaos_pair["jeng"]
    jcache = dict(jax.tree.map(jnp.asarray, {"layers": {
        k: v.numpy() for k, v in cache["layers"].items()}}),
        pos=jnp.asarray(1, jnp.int32))
    jgot, _ = jeng.pdecode.step(jeng.params, jcache,
                                jnp.asarray(tok.numpy(), jnp.int32),
                                layer_ok=jnp.zeros((cfg.n_layers,), bool),
                                head_ok=jnp.asarray(False))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4,
                               atol=1e-4)


def test_checkpoint_ring_snapshots_survive_in_place_writes():
    """The ring's snapshots are clones of the live cache: a slot reset
    after a checkpoint leaves the snapshot whole, and two restores to it
    both find it whole."""
    eng = ts.Engine(t_smoke("mamba2-130m"), slots=SLOTS, device="cpu",
                    ckpt_keep=4)
    eng.run(ts.make_requests(eng.cfg, 3, 6, seed=SEED))
    assert len(eng.ckpts) == 4
    for t in eng.cache["layers"].values():
        t.normal_()
    eng._checkpoint()
    snap = {k: t.clone() for k, t in eng.cache["layers"].items()}
    eng._reset_slot(0)
    for _ in range(2):
        eng._restore(eng.tick)
        for k, t in eng.cache["layers"].items():
            torch.testing.assert_close(t, snap[k], rtol=0, atol=0)
        eng._reset_slot(1)
