"""Step watchdog and straggler detection (port of the serving part of
``repro.runtime.supervisor``; its training ``Supervisor`` is not ported).

* :class:`StepWatchdog` keeps an EMA of step wall time and flags steps
  longer than ``deadline_factor`` times it;
* :func:`detect_stragglers` returns the hosts whose step time exceeds
  ``threshold`` times the median.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger("repro_torch.supervisor")

__all__ = ["StepWatchdog", "detect_stragglers"]


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
