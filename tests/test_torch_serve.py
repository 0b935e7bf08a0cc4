"""Port parity for the whole slice: the port's serving ``Engine`` on the CPU,
with the JAX engine's parameters and converted PCILT bundle carried across
the bridge, serves the same tokens as the JAX ``Engine`` (4 slots, the
engine's 4-bit group-2 PCILT decode, sentinel on).

Every step is checked: the port feeds the same tokens as the reference,
and its logits agree to 1e-5.  The head's logits lie on a coarse grid
(4-bit weights times 4-bit activations), so two of them can tie exactly
in exact arithmetic; float32 rounding in another summation order then picks
either.  Where the port's greedy token differs, the test requires such a
tie — the reference's choice within 1e-5 of the port's maximum — and
samples the reference's logits, so the two streams stay comparable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.launch.serve import Engine as JEngine
from repro.launch.serve import _make_requests
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.interop import bundle_from_jax, params_from_jax
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.launch.serve import make_requests
from test_torch_donor import hash_free_engines

N_REQ, MAX_NEW, SLOTS, SEED = 5, 6, 4, 3
TOL = 1e-5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference engine's run, with the tokens fed and the logits of
    every step recorded."""
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                               pcilt=JPCILT(act_bits=4, group=2),
                               dtype=jnp.float32)
    with hash_free_engines():  # weights independent of PYTHONHASHSEED
        jeng = JEngine(jcfg, max_len=256, slots=SLOTS, pcilt=True)
    # The reference's health monitor changes no token unless it finds a
    # breach, and its per-tick CRC and oracle checks are most of this run's
    # time on the CPU: it reports no breaches here (the port's monitor runs
    # and must report none; tests/test_torch_resilience.py holds the two
    # monitors to each other).
    jeng.monitor.on_tick = lambda tick, sat=None, rows=1: []
    log = []
    raw = jeng._raw_step

    def logged():
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits)))
        return logits, cache

    jeng._raw_step = logged
    jreqs = _make_requests(jcfg, N_REQ, MAX_NEW, None, SEED)
    jstats = jeng.run(jreqs)
    yield {"jeng": jeng, "jreqs": jreqs, "jstats": jstats, "log": log}
    atn.reset_cache()


def _port_engine(served, **kw):
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=4, group=2),
                               dtype=torch.float32)
    jeng = served["jeng"]
    eng = TEngine(
        tcfg, slots=SLOTS, pcilt=True, device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu"),
        pcilt_bundle=bundle_from_jax(jeng.pdecode.pcilt, "cpu"), **kw)
    checked = {"steps": 0, "ties": 0}
    raw = eng._raw_step

    def compared():
        fed, want = served["log"][checked["steps"]]
        np.testing.assert_array_equal(eng.tokens, fed)
        logits, cache = raw()
        got = logits.numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
            assert got[b, want[b].argmax()] >= got[b].max() - TOL, \
                f"step {checked['steps']} row {b}: not a tie"
            checked["ties"] += 1
        checked["steps"] += 1
        return torch.from_numpy(want.copy()), cache

    eng._raw_step = compared
    return tcfg, eng, checked


@pytest.mark.parametrize("sentinel", [True, False])
def test_engine_serves_reference_tokens(served, sentinel):
    assert served["jstats"]["served"] == N_REQ  # the reference ran clean
    tcfg, eng, checked = _port_engine(served, sentinel=sentinel)
    reqs = make_requests(tcfg, N_REQ, MAX_NEW, SEED)
    for r, q in zip(reqs, served["jreqs"]):
        np.testing.assert_array_equal(r.prompt, q.prompt)
    stats = eng.run(reqs)
    assert checked["steps"] == len(served["log"])
    assert checked["ties"] <= checked["steps"]
    assert stats["served"] == N_REQ
    assert all(r.outcome == "served" and r.done for r in reqs)
    assert [r.out for r in reqs] == [q.out for q in served["jreqs"]]
    assert stats["decode_ticks"] == served["jstats"]["decode_ticks"]
    assert stats["prefill_ticks"] == served["jstats"]["prefill_ticks"]
    # both count the conv and projection stacks (not the head's pool)
    assert stats["table_bytes"] == served["jstats"]["table_bytes"]
    assert len(eng.step_seconds) == checked["steps"]
    # the health monitor ran every tick and found nothing to demote
    assert stats["health_events"] == []
    assert stats["restarts"] == stats["rollbacks"] == 0
    if sentinel:  # the counters fed the monitor: the reference's summary
        for key in ("rate", "ewma", "peak_ratio"):
            assert set(stats["saturation"][key]) == {"in", "conv", "out"}
        assert stats["recalibrations"] == 0
    else:
        assert "saturation" not in stats


def test_finite_gate_refuses_poisoned_state(served):
    tcfg, eng, _ = _port_engine(served)
    eng._raw_step = eng.__class__._raw_step.__get__(eng)  # uncompared step
    eng.cache["layers"]["ssd"][0, 1, 0, 0, 0] = float("nan")
    eng.tokens[:] = 3
    with pytest.raises(RuntimeError, match="non-finite"):
        eng._step()
