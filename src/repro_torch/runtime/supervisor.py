"""Step watchdog, straggler detection and the supervised train loop (port
of ``repro.runtime.supervisor``).

* :class:`StepWatchdog` keeps an EMA of step wall time and flags steps
  longer than ``deadline_factor`` times it;
* :func:`detect_stragglers` returns the hosts whose step time exceeds
  ``threshold`` times the median;
* :class:`Supervisor` runs the train loop: on any step failure it restores
  the latest good checkpoint and replays from there, up to
  ``max_restarts`` times.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

log = logging.getLogger("repro_torch.supervisor")

__all__ = ["StepWatchdog", "detect_stragglers", "Supervisor"]


class StepWatchdog:
    def __init__(self, deadline_factor: float = 3.0, ema: float = 0.9,
                 min_samples: int = 5):
        self.deadline_factor = deadline_factor
        self.ema_coef = ema
        self.min_samples = min_samples
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """True when the step breached its deadline."""
        slow = False
        if self.ema is not None and self.n >= self.min_samples:
            slow = dt > self.deadline_factor * self.ema
        self.ema = dt if self.ema is None else (
            self.ema_coef * self.ema + (1 - self.ema_coef) * dt)
        self.n += 1
        if slow:
            self.flagged.append(step)
            log.warning("step %d took %.3fs (deadline %.3fs) — straggler?",
                        step, dt, self.deadline_factor * (self.ema or dt))
        return slow


def detect_stragglers(host_step_times: Sequence[float],
                      threshold: float = 2.0) -> List[int]:
    """Host ids whose step time exceeds ``threshold × median``."""
    t = np.asarray(host_step_times, np.float64)
    med = np.median(t)
    return [int(i) for i in np.nonzero(t > threshold * med)[0]]


@dataclasses.dataclass
class Supervisor:
    """Run ``n_steps`` of ``step_fn`` with checkpoint/restart semantics.

    step_fn(state, step) -> state        (may raise)
    save_fn(state, step) -> None         (called every ``ckpt_every``)
    restore_fn() -> (step, state) | None (latest good checkpoint)
    """

    step_fn: Callable
    save_fn: Callable
    restore_fn: Callable
    ckpt_every: int = 10
    max_restarts: int = 3

    def run(self, state, n_steps: int, start_step: int = 0):
        step = start_step
        restarts = 0
        watchdog = StepWatchdog()
        while step < n_steps:
            try:
                t0 = time.time()
                state = self.step_fn(state, step)
                watchdog.observe(step, time.time() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(state, step)
            except Exception as e:  # noqa: BLE001 — any step fault
                restarts += 1
                log.error("step %d failed (%s); restart %d/%d",
                          step, e, restarts, self.max_restarts)
                if restarts > self.max_restarts:
                    raise
                restored = self.restore_fn()
                if restored is None:
                    raise RuntimeError("no checkpoint to restore from") from e
                step, state = restored
        return step, state, {"restarts": restarts,
                             "straggler_steps": watchdog.flagged}
