"""repro_torch.runtime — the serving engine's clocks, traffic, watchdog and
fault injection (the reference's ``runtime`` without its training
``Supervisor`` and ``pipeline_apply``)."""

from .supervisor import StepWatchdog, detect_stragglers
from .faults import FaultInjector
from .traffic import (WallClock, VirtualClock, poisson_arrivals,
                      burst_arrivals, ramp_arrivals, make_arrivals)

__all__ = ["StepWatchdog", "detect_stragglers", "FaultInjector", "WallClock",
           "VirtualClock", "poisson_arrivals", "burst_arrivals",
           "ramp_arrivals", "make_arrivals"]
