"""Share of the profiled forwards' host window in which no device
operation ran."""


def read(rec):
    t = rec.get("trace")
    if not t or "conv0" not in t["segments"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
