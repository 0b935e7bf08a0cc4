"""Share of the profiled decode ticks' host window (steps and what runs
between them) in which no device operation ran."""


def read(rec):
    t = rec.get("trace")
    if not t or "step" not in t["segments"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
