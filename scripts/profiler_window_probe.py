#!/usr/bin/env python3
"""How often ``torch.profiler`` (CUDA activity only) loses device records
of a short profiled window, and whether ``chip_smoke.py``'s padded window
(host idle time on both sides) stops it.

    python3 scripts/profiler_window_probe.py    # needs one CUDA card

Each window runs 32 small matmuls (the decode path's library call at the
wB,wC shape), warm, or cold with an L2 flush before each.  The launches
one window holds are first counted in a padded window; a window that
shows fewer is short of launches (an empty one shows none).  Prints one
line per variant and a JSON object with the counts.
"""

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CALLS = 32


def bare_profile(fn):
    """A window with no padding: ``fn``, then ``synchronize``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return chip_smoke._device_times(prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_window_probe: no CUDA device")
        return 2
    a = torch.randn(4, 256, device="cuda")
    b = torch.randn(256, 128, device="cuda")
    flush = chip_smoke.L2Flush(torch)

    def calls(cold):
        def run():
            for _ in range(CALLS):
                if cold:
                    flush()
                torch.matmul(a, b)
        return run

    def launches(prof):
        return sum(n for k, (n, _) in prof.items()
                   if chip_smoke.FLUSH_KERNEL not in k)

    torch.matmul(a, b)
    expect = launches(chip_smoke._profile(torch, calls(False)))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{expect} launches per window of {CALLS} calls", flush=True)
    result = {"launches_per_window": expect, "variants": {}}
    for name, prof_fn, cold, n in (
            ("bare warm", bare_profile, False, 600),
            ("bare cold", bare_profile, True, 300),
            ("padded warm", lambda f: chip_smoke._profile(torch, f), False,
             300),
            ("padded cold", lambda f: chip_smoke._profile(torch, f), True,
             300)):
        t0 = time.perf_counter()
        empty = short = 0
        for _ in range(n):
            got = launches(prof_fn(calls(cold)))
            empty += got == 0
            short += 0 < got < expect
        result["variants"][name] = {"windows": n, "empty": empty,
                                    "short": short}
        print(f"{name:12s} windows {n}: empty {empty}, short of launches "
              f"{short} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
