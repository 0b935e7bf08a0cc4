"""The readings a limit of ``correct`` is set from: for each seed, a whole
run of the cell (set-up, a window at the cell's own load, the check) and,
with ``--control tf32``, the control's number on the same outputs: the
reference computed with TF32 in its matmuls and convolutions, the
precision below the configurations' float32.  All seeds run in one
process, so the port's kernels load once.

    python3 portbench/readings.py --workload NAME --seeds 1,2,3 \\
        --seconds 30 [--control tf32]

Prints one JSON line a seed and a last line with, for each number, the
largest reading of the port and the smallest of the control.
"""

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]

from portbench import harness, manifest  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)
    harness.set_environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load(ROOT)
    port, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, t0, "cuda", ROOT, args.control)
        got = rec["numbers"]
        for k, v in got.items():
            port[k] = max(port.get(k, v), v)
        for k, v in rec["control"].items():
            control[k] = min(control.get(k, v), v)
        print(json.dumps({"seed": seed, "port": got,
                          "control": rec["control"], "diag": rec["diag"],
                          "window": rec["window"],
                          "peak": rec["memory_peak_bytes"]}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"workload": args.workload, "port_max": port,
                      "control_min": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
