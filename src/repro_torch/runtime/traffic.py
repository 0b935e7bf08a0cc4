"""Open-loop traffic for the serving engine (port of
``repro.runtime.traffic``).

An open-loop arrival process fixes the *offered* load independently of the
engine's progress, the only honest way to measure shed rate and tail
latency past capacity.  This module holds:

* seeded arrival processes (:func:`poisson_arrivals`,
  :func:`burst_arrivals`, :func:`ramp_arrivals`, dispatched by
  :func:`make_arrivals`): absolute arrival times, the same arrays as the
  reference's for the same seed;
* the clocks the engine takes (``Engine(clock=...)``): :class:`WallClock`
  (real time, the default) and :class:`VirtualClock` (``sleep`` advances
  virtual time instead of blocking, so deadline and backoff paths run
  deterministically at full speed).

With ``Engine(step_cost_s=...)`` each engine step advances the virtual
clock by a fixed service time, which makes capacity analytic.
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np

__all__ = ["WallClock", "VirtualClock", "poisson_arrivals", "burst_arrivals",
           "ramp_arrivals", "make_arrivals", "PROFILES"]


class WallClock:
    """Real time, real sleeps."""

    def time(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


class VirtualClock:
    """A deterministic clock: ``sleep`` advances virtual time, never
    blocks."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def time(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._t += float(seconds)

    advance = sleep


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """``n`` absolute arrival times of a Poisson process at ``rate``
    requests/s from ``t0`` (exponential gaps)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    return t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))


def burst_arrivals(n: int, rate: float, burst: int = 4, seed: int = 0,
                   t0: float = 0.0) -> np.ndarray:
    """Arrivals in groups of ``burst`` at the same average ``rate``: the
    gaps between groups are stretched by ``burst``."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    rng = np.random.default_rng(seed)
    n_groups = -(-n // burst)
    group_t = t0 + np.cumsum(rng.exponential(burst / rate, size=n_groups))
    return np.repeat(group_t, burst)[:n]


def ramp_arrivals(n: int, rate: float, rate_end: Optional[float] = None,
                  seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Arrivals whose rate ramps linearly from ``rate`` to ``rate_end``
    (default ``2 * rate``) across the stream: the overload onset."""
    if rate_end is None:
        rate_end = 2.0 * rate
    if rate <= 0 or rate_end <= 0:
        raise ValueError(f"rates must be positive, got {rate}, {rate_end}")
    rng = np.random.default_rng(seed)
    rates = np.linspace(rate, rate_end, n)
    return t0 + np.cumsum(rng.exponential(1.0, size=n) / rates)


PROFILES = ("poisson", "burst", "ramp")


def make_arrivals(profile: str, n: int, rate: float, seed: int = 0,
                  t0: float = 0.0, **kw) -> np.ndarray:
    """Dispatch by profile name (the ``--traffic`` CLI surface)."""
    if profile == "poisson":
        return poisson_arrivals(n, rate, seed=seed, t0=t0, **kw)
    if profile == "burst":
        return burst_arrivals(n, rate, seed=seed, t0=t0, **kw)
    if profile == "ramp":
        return ramp_arrivals(n, rate, seed=seed, t0=t0, **kw)
    raise ValueError(f"unknown traffic profile {profile!r} "
                     f"(known: {PROFILES})")
