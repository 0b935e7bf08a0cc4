"""Device milliseconds, an image, of every operation between the markers
around the last convolution's call (the paper's conv4)."""


def read(rec):
    t = rec.get("trace")
    if not t or "conv4" not in t["segments"] or not t["units"]:
        return None
    return 1e3 * t["segments"]["conv4"]["device_s"] / t["units"]
