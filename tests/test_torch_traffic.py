"""Port parity of open-loop serving: ``Engine.run_traffic`` on a
``VirtualClock`` (poisson, burst and ramp arrivals at twice the analytic
capacity, a bounded queue and per-request deadlines) gives the JAX
``Engine``'s outcomes, shed rate, evictions, retries, telemetry
(``queue_depth``, ``active_slots``, ``t`` of every tick) and tokens, and
``verify_accounting`` trips on a lost request as the reference's does.

The engines serve the dense mamba2-130m smoke model (the admission,
scheduling and deadline logic is the same with and without PCILT, and
runs in far fewer seconds without it) on the JAX engine's parameters.
Steps are compared as in ``tests/test_torch_serve.py``: the same tokens
fed, logits within 1e-4, a differing greedy token only at a tie (the
reference's fed on to both).  On the virtual clock time advances only by
the simulated step cost and the engine's own sleeps, so the schedule does
not depend on the machine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as js
from repro.runtime import VirtualClock as JClock
from repro.runtime import make_arrivals as j_arrivals
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as ts
from repro_torch.runtime import VirtualClock, make_arrivals
from test_torch_donor import hash_free_engines

SLOTS, N_REQ, MAX_NEW, SEED = 2, 10, 4, 2
STEP_COST, QUEUE_LIMIT, DEADLINE = 1e-3, 3, 0.008
TOL = 1e-4


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(j_smoke("mamba2-130m"), dtype=jnp.float32),
            dataclasses.replace(t_smoke("mamba2-130m"), dtype=torch.float32))


@pytest.fixture(scope="module", params=["poisson", "burst", "ramp"])
def traffic_pair(request, cfgs):
    jcfg, tcfg = cfgs
    steps_per_req = 7.5 + MAX_NEW / SLOTS
    rate = 2.0 / (steps_per_req * STEP_COST)  # 2x capacity
    arrivals = make_arrivals(request.param, N_REQ, rate, seed=SEED)
    np.testing.assert_array_equal(
        arrivals, j_arrivals(request.param, N_REQ, rate, seed=SEED))

    with hash_free_engines():  # weights independent of PYTHONHASHSEED
        jeng = js.Engine(jcfg, max_len=64, slots=SLOTS, clock=JClock(),
                         step_cost_s=STEP_COST, queue_limit=QUEUE_LIMIT)
    log = []
    raw = jeng._raw_step

    def logged():
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits)))
        return logits, cache

    jeng._raw_step = logged
    jreqs = js._make_requests(jcfg, N_REQ, MAX_NEW, DEADLINE, SEED)
    jstats = jeng.run_traffic(jreqs, arrivals)

    teng = ts.Engine(tcfg, slots=SLOTS, device="cpu", clock=VirtualClock(),
                     step_cost_s=STEP_COST, queue_limit=QUEUE_LIMIT,
                     params=params_from_jax(jax.tree.map(np.asarray,
                                                         jeng.params), "cpu"))
    seen = {"steps": 0}
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
        return torch.from_numpy(want.copy()), cache

    teng._raw_step = compared
    treqs = ts.make_requests(tcfg, N_REQ, MAX_NEW, SEED, DEADLINE)
    tstats = teng.run_traffic(treqs, arrivals)
    return dict(profile=request.param, jstats=jstats, tstats=tstats,
                jreqs=jreqs, treqs=treqs, seen=seen, log=log)


def test_same_outcomes_shed_and_evictions(traffic_pair):
    p = traffic_pair
    t, j = p["tstats"], p["jstats"]
    assert p["seen"]["steps"] == len(p["log"])
    for key in ("outcomes", "offered", "served", "degraded", "failed",
                "rejected", "shed_rate", "retried", "queue_evictions",
                "slot_evictions", "decode_ticks", "prefill_ticks",
                "restarts", "rollbacks", "wall_s"):
        assert t[key] == j[key], key
    # twice the capacity into a 3-deep queue, deadlines of ~8 steps: shed
    # at the door, evicted from slots, retried after a backoff, failed
    assert t["rejected"] > 0 and t["slot_evictions"] > 0
    assert t["retried"] > 0 and t["failed"] > 0
    ts.verify_accounting(p["treqs"], t)


def test_same_telemetry(traffic_pair):
    t, j = traffic_pair["tstats"]["telemetry"], \
        traffic_pair["jstats"]["telemetry"]
    assert len(t) == len(j) > 0
    for key in ("tick", "t", "queue_depth", "pending", "active_slots",
                "occupancy", "queue_evictions", "slot_evictions", "tick_s"):
        assert [e[key] for e in t] == [e[key] for e in j], key


def test_same_tokens_and_latencies(traffic_pair):
    p = traffic_pair
    assert [r.out for r in p["treqs"]] == [r.out for r in p["jreqs"]]
    for a, b in zip(p["treqs"], p["jreqs"]):
        assert (a.outcome, a.retries, a.done, a.t_arrive, a.t_done) == \
            (b.outcome, b.retries, b.done, b.t_arrive, b.t_done)
    assert ts.token_latencies(p["treqs"]) == js.token_latencies(p["jreqs"])


def test_verify_accounting_trips_on_a_lost_request(traffic_pair):
    p = traffic_pair
    reqs, stats = p["treqs"], dict(p["tstats"])
    lost = reqs[0]
    saved = (lost.outcome, lost.done)
    try:
        lost.outcome = "queued"  # never reached a terminal outcome
        with pytest.raises(SystemExit, match="without a terminal outcome"):
            ts.verify_accounting(reqs, stats)
        lost.outcome, lost.done = saved[0], False
        with pytest.raises(SystemExit, match="done=False"):
            ts.verify_accounting(reqs, stats)
    finally:
        lost.outcome, lost.done = saved
    stats["offered"] += 1  # a request the counts never saw
    with pytest.raises(SystemExit, match="accounting violated"):
        ts.verify_accounting(reqs, stats)
    with pytest.raises(SystemExit, match="accounting violated"):
        js.verify_accounting(p["jreqs"], stats)


def test_run_traffic_rejects_a_short_trace(cfgs):
    eng = ts.Engine(cfgs[1], slots=SLOTS, device="cpu", clock=VirtualClock())
    with pytest.raises(ValueError, match="cover every request"):
        eng.run_traffic(ts.make_requests(cfgs[1], 3, 2, 0), [0.0, 1.0])


def test_cli_chaos_under_traffic_on_the_cpu(capsys):
    """``--pcilt --traffic poisson --chaos --device cpu``: both contracts
    at once, on the port alone."""
    ts.main(["--arch", "mamba2-130m", "--pcilt", "--traffic", "poisson",
             "--chaos", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "accounting invariant verified" in out
    assert "chaos-under-traffic contract verified" in out
