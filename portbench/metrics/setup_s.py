"""Set-up seconds: process start to the first timed request (imports, the
CUDA context, the kernel libraries, weights, conversion, warm-up)."""


def read(rec):
    return rec.get("setup_s")
