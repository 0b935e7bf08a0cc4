"""Port parity of the calibration-drift sentinel end to end: the port's
``Engine`` on the CPU, given the JAX engine's parameters and converted
bundle, goes through the ``--chaos-drift`` plan (layer 1's mixer norm gain
times 64 at step 10) exactly as the JAX ``Engine`` does: the same
demotion (layer 1, the same tick, grid and state), the same rollback and
recalibration, recalibrated scales within 1e-6 relative of the
reference's, the rewritten tables bit-equal to the port's fresh build at
the new scale and within 1e-5 of the reference's, the same outcomes and
tokens.  The sticky cases (the conv grid; a spent budget) and the EWMA
classification are held to the reference's monitor directly.

Steps are compared as in ``tests/test_torch_resilience.py``: the same
tokens fed, logits within 1e-4, a differing greedy token only at an exact
tie (the reference's fed on to both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.core.serving import HealthMonitor as JMonitor
from repro.core.serving import PCILTMambaDecode as JDecode
from repro.launch import serve as js
from repro.runtime.faults import FaultInjector as JInjector
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.core.pcilt import build_grouped_tables, table_checksum
from repro_torch.core.serving import HealthMonitor, PCILTMambaDecode
from repro_torch.interop import bundle_from_jax, params_from_jax
from repro_torch.launch import serve as ts
from repro_torch.runtime import FaultInjector
from test_torch_donor import hash_free_engines

SLOTS, N_REQ, MAX_NEW, SEED = 2, 3, 4, 0
TOL = 1e-4


def _copy_bundle(obj):
    if isinstance(obj, dict):
        return {k: _copy_bundle(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy_bundle(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def drift(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                               pcilt=JPCILT(act_bits=4, group=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=4, group=2),
                               dtype=torch.float32)
    with hash_free_engines():  # weights independent of PYTHONHASHSEED
        donor = js.Engine(jcfg, max_len=64, slots=SLOTS, pcilt=True)
        params = jax.tree.map(np.asarray, donor.params)
        clean = donor.pdecode.pcilt  # never mutated: engines get copies
        jeng = js.Engine(jcfg, max_len=64, slots=SLOTS, pcilt=True,
                         pcilt_bundle=_copy_bundle(clean))
    jinj = JInjector(seed=SEED)
    jeng.chaos = js._chaos_drift_plan(jeng, jinj)
    log = []
    raw = jeng._raw_step

    def logged():
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits)))
        return logits, cache

    jeng._raw_step = logged
    jreqs = js._make_requests(jcfg, N_REQ, MAX_NEW, None, SEED)
    jstats = jeng.run(jreqs)

    teng = ts.Engine(tcfg, slots=SLOTS, pcilt=True, device="cpu",
                     params=params_from_jax(params, "cpu"),
                     pcilt_bundle=bundle_from_jax(clean, "cpu"))
    tinj = FaultInjector(seed=SEED)
    teng.chaos = ts._chaos_drift_plan(teng, tinj)
    seen = {"steps": 0, "ties": 0}
    traw = teng._raw_step

    def compared():
        fed, want = log[seen["steps"]]
        seen["steps"] += 1
        np.testing.assert_array_equal(teng.tokens, fed)
        logits, cache = traw()
        got = logits.numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
            assert got[b, want[b].argmax()] >= got[b].max() - TOL
            seen["ties"] += 1
        return torch.from_numpy(want.copy()), cache

    teng._raw_step = compared
    treqs = ts.make_requests(tcfg, N_REQ, MAX_NEW, SEED)
    tstats = teng.run(treqs)
    yield dict(jcfg=jcfg, tcfg=tcfg, params=params, clean=clean, jeng=jeng,
               jreqs=jreqs, jstats=jstats, jinj=jinj, teng=teng, treqs=treqs,
               tstats=tstats, tinj=tinj, seen=seen, log=log)
    atn.reset_cache()


def _of(stats, kind):
    return [e for e in stats["health_events"] if e["kind"] == kind]


def test_same_demotion(drift):
    t, j = drift["tstats"], drift["jstats"]
    assert drift["seen"]["steps"] == len(drift["log"])
    assert drift["tinj"].events == drift["jinj"].events
    td, jd = _of(t, "drift"), _of(j, "drift")
    assert [(e["layer"], e["tick"], e["grid"], e["state"], e["reason"])
            for e in td] == [(e["layer"], e["tick"], e["grid"], e["state"],
                              e["reason"]) for e in jd]
    assert td and all(e["layer"] == ts.DRIFT_LAYER for e in td)
    for a, b in zip(td, jd):
        assert a["rate"] == b["rate"] and a["ewma"] == b["ewma"]
        assert a["ratio"] == pytest.approx(b["ratio"], rel=1e-6)


def test_same_rollback_recalibration_and_outcomes(drift):
    t, j = drift["tstats"], drift["jstats"]
    for key in ("rollbacks", "restarts", "recalibrations", "outcomes",
                "decode_ticks", "prefill_ticks", "served", "degraded"):
        assert t[key] == j[key], key
    assert t["rollbacks"] >= 1 and t["recalibrations"] >= 1
    assert [e["kind"] for e in t["health_events"]] == \
        [e["kind"] for e in j["health_events"]]
    assert [r.out for r in drift["treqs"]] == [r.out for r in drift["jreqs"]]
    assert all(drift["teng"].monitor.layer_ok)
    assert drift["teng"].monitor.tainted and drift["jeng"].monitor.tainted
    summary = t["saturation"]
    assert summary["recalibrations"] == j["saturation"]["recalibrations"]
    assert summary["tainted"] is True and summary["pending"] == 0
    assert all("saturation" in e for e in t["telemetry"])


def test_recalibrated_scales_and_tables(drift):
    """Scales within 1e-6 relative of the reference's; the rewritten layer
    bit-equal to a fresh build at the new scale (conversion's arithmetic),
    within 1e-5 of the reference's rewritten layer, its CRC record
    re-recorded; the other layers untouched."""
    t, j = drift["tstats"], drift["jstats"]
    trec, jrec = _of(t, "recalibrate"), _of(j, "recalibrate")
    assert [(e["layer"], e["tick"], e["grid"], e["attempt"]) for e in trec] \
        == [(e["layer"], e["tick"], e["grid"], e["attempt"]) for e in jrec]
    proj = drift["teng"].pdecode.pcilt["proj"]
    jproj = drift["jeng"].pdecode.pcilt["proj"]
    clean = bundle_from_jax(drift["clean"], "cpu")["proj"]
    for te, je in zip(trec, jrec):
        assert te["amax_ratio"] == pytest.approx(je["amax_ratio"], rel=1e-6)
        assert set(te["scales"]) == set(je["scales"])
        l = te["layer"]
        for name, s in te["scales"].items():
            assert s == pytest.approx(je["scales"][name], rel=1e-6)
            assert float(proj["scales"][name][l]) == s
            w = params_from_jax(drift["params"], "cpu")["blocks"]["mixer"][
                name]["kernel"][l].float()
            pad = (-w.shape[0]) % proj["group"]
            if pad:
                w = torch.cat([w, w.new_zeros((pad, w.shape[1]))], 0)
            fresh = build_grouped_tables(w, proj["spec"], s, proj["group"])
            got = proj["tables"][name][l]
            assert torch.equal(got, fresh)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jproj["tables"][name][l]),
                                       rtol=1e-5, atol=1e-5)
            integ = drift["teng"].pdecode.pcilt["integrity"]["proj"][name]
            assert integ[l] == table_checksum(got)
            for other in range(drift["tcfg"].n_layers):
                if other != l:
                    assert torch.equal(proj["tables"][name][other],
                                       clean["tables"][name][other])
    assert drift["teng"].pdecode.verify_integrity() == []


def _monitors(drift):
    """Fresh monitors over fresh copies of the clean bundle, the port's and
    the reference's."""
    jdec = JDecode(drift["jeng"].model, _copy_bundle(drift["clean"]))
    jm = JMonitor(jdec, drift["jeng"].params, oracle_every=0)
    tdec = PCILTMambaDecode(drift["teng"].model,
                            bundle_from_jax(drift["clean"], "cpu"))
    tm = HealthMonitor(tdec, params_from_jax(drift["params"], "cpu"),
                       oracle_every=0)
    return tm, jm


def test_conv_grid_and_spent_budget_stay_sticky(drift):
    tm, jm = _monitors(drift)
    for m in (tm, jm):
        m.layer_ok[0] = False
        m.layer_ok[1] = False
        m.sat_peak["out"][1] = 4.0
        m.recalibrations[1] = m.max_recalibrations
    for args in ((0, "conv", 1), (1, "out", 2)):
        te, je = tm.recalibrate_layer(*args), jm.recalibrate_layer(*args)
        assert te == je and te["kind"] == "drift_sticky"
    assert list(tm.layer_ok) == list(jm.layer_ok) == [False, False]
    assert tm.events == jm.events and not tm.tainted


@pytest.mark.parametrize("pattern", ["sustained", "instant", "healthy"])
def test_ewma_classification_equals_the_reference(drift, pattern):
    """Synthetic counters through both sentinels: the same states, events
    and pending queue, tick after tick."""
    tm, jm = _monitors(drift)
    L = tm.n_layers
    rate, grid, layer = {"sustained": (0.05, "out", 1),
                         "instant": (0.9, "in", 0),
                         "healthy": (0.001, "conv", 1)}[pattern]
    for tick in range(12):
        sat = {}
        for g in tm.SAT_GRIDS:
            cnt = np.zeros(L, np.int32)
            ratio = np.zeros(L, np.float32)
            if g == grid:
                cnt[layer] = int(rate * tm._sat_elems[g] * SLOTS)
                ratio[layer] = 1.0 + tick
            sat[g] = {"count": cnt, "ratio": ratio}
        tb = tm.observe_saturation(tick, sat, rows=SLOTS)
        jb = jm.observe_saturation(tick, jax.tree.map(jnp.asarray, sat),
                                   rows=SLOTS)
        assert tb == jb
        assert tm.saturation_state(grid, layer) == \
            jm.saturation_state(grid, layer)
    assert tm.drift_pending == jm.drift_pending
    assert tm.saturation_summary() == jm.saturation_summary()
    assert bool(tm.events) == (pattern != "healthy")


def test_cli_drift_contract_on_the_cpu(capsys):
    """``--pcilt --chaos-drift --device cpu``: the port's own contract."""
    ts.main(["--arch", "mamba2-130m", "--pcilt", "--chaos-drift", "--device",
             "cpu"])
    out = capsys.readouterr().out
    assert "drift contract verified: 6 requests completed" in out
    assert "bit-equal to fresh build at the new scale" in out
