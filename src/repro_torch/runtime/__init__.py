"""repro_torch.runtime — the serving engine's clocks and traffic, the
watchdog, fault injection and the training ``Supervisor`` (the reference's
``runtime``) and the stage pipeline (``pipeline_apply``)."""

from .supervisor import StepWatchdog, detect_stragglers, Supervisor
from .faults import FaultInjector
from .pipeline import pipeline_apply
from .traffic import (WallClock, VirtualClock, poisson_arrivals,
                      burst_arrivals, ramp_arrivals, make_arrivals)

__all__ = ["StepWatchdog", "detect_stragglers", "Supervisor", "FaultInjector",
           "WallClock", "VirtualClock", "poisson_arrivals", "burst_arrivals",
           "ramp_arrivals", "make_arrivals", "pipeline_apply"]
