"""Share of the roofline of the profiled forwards: the least time of each
convolution's work (``work.cnn_image``: max of fetch-adds at the float32
peak and bytes at the HBM peak), summed, over the device time of every
operation of the forward, whatever kernels run it."""


def read(rec):
    t, p = rec.get("trace"), rec.get("peaks")
    if not t or not p or "conv0" not in t["segments"] or t["device_s"] <= 0:
        return None
    least = sum(max(l["ops"] / p["float32_ops_per_s"],
                    l["bytes"] / p["hbm_bytes_per_s"])
                for l in rec["work"]["image"]["layers"])
    return 100.0 * least * t["units"] / t["device_s"]
