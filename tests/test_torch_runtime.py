"""Port parity of ``repro_torch.runtime`` against ``repro.runtime``: the
same clocks and the same arrival arrays for the same seeds, the same fault
sites and events from a ``FaultInjector`` of the same seed (the same
``np.random.default_rng`` draws in the same order), the port's in-place
table corruption touching exactly the recorded sites, and the same
straggler steps from ``StepWatchdog`` and ``detect_stragglers``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import faults as jf
from repro.runtime import supervisor as jsup
from repro.runtime import traffic as jt
from repro_torch.interop import to_numpy, to_torch
from repro_torch.runtime import (FaultInjector, StepWatchdog, VirtualClock,
                                 WallClock, detect_stragglers, traffic)


@pytest.mark.parametrize("profile", ["poisson", "burst", "ramp"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_arrivals_equal_the_reference(profile, seed):
    for n, rate, t0 in [(1, 5.0, 0.0), (37, 120.0, 1.5), (200, 0.7, 0.0)]:
        np.testing.assert_array_equal(
            traffic.make_arrivals(profile, n, rate, seed=seed, t0=t0),
            jt.make_arrivals(profile, n, rate, seed=seed, t0=t0))


def test_arrival_options_and_errors_equal_the_reference():
    np.testing.assert_array_equal(traffic.burst_arrivals(10, 4.0, burst=3),
                                  jt.burst_arrivals(10, 4.0, burst=3))
    np.testing.assert_array_equal(
        traffic.ramp_arrivals(10, 4.0, rate_end=1.0, seed=2),
        jt.ramp_arrivals(10, 4.0, rate_end=1.0, seed=2))
    for fn, args in [(traffic.poisson_arrivals, (3, 0.0)),
                     (traffic.burst_arrivals, (3, 1.0, 0)),
                     (traffic.ramp_arrivals, (3, 1.0, -1.0)),
                     (traffic.make_arrivals, ("square", 3, 1.0))]:
        with pytest.raises(ValueError):
            fn(*args)
    assert traffic.PROFILES == jt.PROFILES


def test_clocks():
    v, jv = VirtualClock(2.0), jt.VirtualClock(2.0)
    for dt in (0.5, -1.0, 0.0, 1e-9, 3.25):
        v.sleep(dt)
        jv.sleep(dt)
        assert v.time() == jv.time()
    v.advance(1.0)
    assert v.time() == jv.time() + 1.0
    w = WallClock()
    t0 = w.time()
    w.sleep(0.01)
    assert w.time() - t0 >= 0.009


def _pair(seed, **kw):
    return FaultInjector(seed=seed, **kw), jf.FaultInjector(seed=seed, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_flips", [1, 2, 7])
def test_corrupt_table_in_place_at_the_reference_sites(dtype, n_flips):
    """The same sites and event as the reference's; the port flips in
    place (the returned tensor is the one it was given), exactly the
    recorded sites change, and to the reference's values."""
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    a = np.random.default_rng(1).normal(size=(3, 4, 16, 5)).astype(npdt)
    t = to_torch(a.copy())
    inj, jinj = _pair(5)
    got = inj.corrupt_table(t, n_flips=n_flips)
    want = np.asarray(jinj.corrupt_table(jnp.asarray(a), n_flips=n_flips))
    assert got is t
    assert inj.events == jinj.events
    changed = np.argwhere(to_numpy(t).astype(np.float32)
                          != a.astype(np.float32))
    assert sorted(map(tuple, changed)) == sorted(inj.events[0]["sites"])
    np.testing.assert_array_equal(to_numpy(t).astype(np.float32),
                                  want.astype(np.float32))


def test_corrupt_table_refuses_a_strided_view():
    with pytest.raises(ValueError, match="contiguous"):
        FaultInjector().corrupt_table(torch.zeros(4, 6)[:, ::2])


@pytest.mark.parametrize("n_pool,n_flips", [(8, 1), (8, 4), (1, 1), (3, 5)])
def test_flip_seg_idx_equals_the_reference(n_pool, n_flips):
    seg = (np.arange(16) % n_pool).astype(np.int32)
    inj, jinj = _pair(0)
    got = inj.flip_seg_idx(torch.from_numpy(seg.copy()), n_pool=n_pool,
                           n_flips=n_flips)
    want = jinj.flip_seg_idx(jnp.asarray(seg), n_pool=n_pool,
                             n_flips=n_flips)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert inj.events == jinj.events


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poison_and_drift_equal_the_reference(kind):
    x = np.random.default_rng(2).normal(size=(2, 3, 8)).astype(np.float32)
    inj, jinj = _pair(4)
    t = torch.from_numpy(x.copy())
    got = inj.poison(t, kind, n=5)
    want = np.asarray(jinj.poison(jnp.asarray(x), kind, n=5))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), x)  # a copy: the input intact
    for rows in (None, [1], [0, 1]):
        got = inj.drift_scale(t, 64.0, rows=rows)
        want = np.asarray(jinj.drift_scale(jnp.asarray(x), 64.0, rows=rows))
        np.testing.assert_array_equal(got.numpy(), want)
    assert inj.events == jinj.events


def test_maybe_fail_and_garble_file_equal_the_reference(tmp_path):
    inj, jinj = _pair(0, fail_at=(3, 5))
    for step in (2, 3, 3, 5, 6):
        for i in (inj, jinj):
            try:
                i.maybe_fail(step)
            except RuntimeError:
                pass
    assert inj.events == jinj.events == [
        {"kind": "step_fault", "step": 3}, {"kind": "step_fault", "step": 5}]
    for mode in ("truncate", "garbage", "empty"):
        for i, name in ((inj, "p"), (jinj, "j")):
            p = tmp_path / f"{name}.json"
            p.write_bytes(b'{"k": [1, 2, 3, 4, 5, 6]}')
            i.garble_file(str(p), mode)
        assert (tmp_path / "p.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
    with pytest.raises(ValueError):
        inj.garble_file(str(tmp_path / "p.json"), "shred")
    inj.garble_file(str(tmp_path / "absent.json"))
    assert inj.events[-1]["absent"] is True


@pytest.mark.parametrize("factor,min_samples", [(3.0, 5), (1.5, 2)])
def test_watchdog_flags_the_reference_steps(factor, min_samples):
    rng = np.random.default_rng(0)
    dts = rng.uniform(0.01, 0.02, 60)
    dts[[7, 19, 33, 34, 50]] *= [5.0, 2.0, 8.0, 1.6, 30.0]
    wd = StepWatchdog(deadline_factor=factor, min_samples=min_samples)
    jwd = jsup.StepWatchdog(deadline_factor=factor, min_samples=min_samples)
    got = [wd.observe(i, float(d)) for i, d in enumerate(dts)]
    want = [jwd.observe(i, float(d)) for i, d in enumerate(dts)]
    assert got == want and wd.flagged == jwd.flagged and wd.flagged
    assert wd.ema == jwd.ema


def test_detect_stragglers_equals_the_reference():
    for times in ([1.0, 1.1, 0.9, 5.0], [2.0] * 8, [1.0, 3.0, 2.5, 0.1]):
        assert detect_stragglers(times) == jsup.detect_stragglers(times)
        assert detect_stragglers(times, 1.2) == \
            jsup.detect_stragglers(times, 1.2)
