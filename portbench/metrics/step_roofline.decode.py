"""Share of the roofline of the profiled decode steps: the least time of
their work (``work.mamba_step``: max of operations at the float32 peak and
bytes at the HBM peak, a step) over the device time of every operation
inside them, whatever kernels run it."""


def read(rec):
    t, p = rec.get("trace"), rec.get("peaks")
    if not t or not p or "step" not in t["segments"]:
        return None
    dev = t["segments"]["step"]["device_s"]
    if dev <= 0:
        return None
    w = rec["work"]["step"]
    least = max(w["ops"] / p["float32_ops_per_s"],
                w["bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * least * t["units"] / dev
