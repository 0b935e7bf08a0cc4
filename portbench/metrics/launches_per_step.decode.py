"""Device launches inside the profiled decode steps, over their count."""


def read(rec):
    t = rec.get("trace")
    if not t or "step" not in t["segments"] or not t["units"]:
        return None
    return t["segments"]["step"]["launches"] / t["units"]
