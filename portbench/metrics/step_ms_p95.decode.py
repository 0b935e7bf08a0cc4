"""95th percentile of the engine's synchronised host milliseconds a step
(``Engine.step_seconds``) over the window, profiled steps left out."""

import numpy as np


def read(rec):
    s = rec["spans"].get("step_s")
    if not s:
        return None
    return float(np.percentile(np.asarray(s) * 1e3, 95))
