"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

A kind (``kinds/<kind>.py``, named by the configuration's ``"kind"``)
sets the port up from the configuration and the seed, warms every shape
the cell's traffic uses, serves the traffic for ``--seconds``, frees the
port and judges what it served against the plain reference.  It returns
the run's record, from which every metric's reader (``metrics/<name>.py``)
takes its number:

* ``setup_s``: process start to the first timed request;
* ``window``: ``seconds`` (all the time of the window) and what was served
  in it: ``requests``, and ``images`` or ``tokens``;
* ``attempted``, ``failed``: requests;
* ``spans``: host seconds the benchmark timed around calls into the port
  (``convert_s``; with ``--trace 1`` also ``monitor_s`` a tick) and the
  port's own ``step_s`` (``Engine.step_seconds``);
* ``work``: operations, bytes and model FLOPs from the shapes
  (:mod:`portbench.work`);
* ``peaks``: the card's published rates (``peaks.json``);
* ``trace`` (``--trace 1``): the profiled stretch's ``window_s``,
  ``busy_s``, ``segments`` (device seconds and launches a label),
  ``units`` (steps or images profiled), ``device_ops``, ``idle_gaps``;
* ``checks``: each number ``correct`` compares, ``[value, limit]``;
  ``numbers``: the port's readings; ``control``: the control's, when
  asked for (``portbench/readings.py``);
* ``memory_peak_bytes``; ``diag``: lines for standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

from . import manifest

#: top-level modules that no process of the benchmark may hold: JAX and the
#: JAX package (``repro``; compared whole, so ``repro_torch`` is not it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; the port's kernels build
    into ``build/kernels`` beside its sources.  The design cache is read
    from a file no run writes, so every run takes the designs the port's
    heuristics choose."""
    cache = Path(root) / "build" / "portbench"
    os.environ["REPRO_PCILT_TUNE_CACHE"] = str(cache / "tiles.json")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.pop("REPRO_PCILT_AUTOTUNE", None)
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def peaks(device_name: str, root: Path) -> Optional[Dict]:
    with open(Path(root) / "portbench" / "peaks.json") as f:
        table = json.load(f)
    for key, row in table.items():
        if key in device_name:
            return row
    return None


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", root: Path = manifest.ROOT,
             control: Optional[str] = None) -> Dict:
    """Set up, serve and judge one cell; returns the record."""
    import torch

    cell = manifest.workload(bench, name)
    cfg = manifest.config(bench, cell["config"], root)
    ctx = {"cfg": cfg,
           "traffic": manifest.traffic(cell["traffic"], root),
           "limits": manifest.limits(name, root), "seed": seed,
           "seconds": seconds, "trace": trace, "device": device,
           "t_process": t_process, "control": control}
    # the configurations state float32: no TF32 in the port's matmuls or
    # convolutions (its calibration passes) nor in the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device != "cpu":
        ctx["peaks"] = peaks(torch.cuda.get_device_name(0), root)
    rec = manifest.module("kinds", cfg["kind"]).run(ctx)
    rec["peaks"] = ctx.get("peaks")
    return rec


def _number(v: float) -> float:
    """A reading as JSON can hold it (a non-finite one as the largest)."""
    return v if math.isfinite(v) else sys.float_info.max


def result(bench: Dict, name: str, rec: Dict, trace: bool, device: Dict,
           root: Path = manifest.ROOT) -> Dict:
    """The result line of a run; ``correct`` holds when every number
    compared is within its limit."""
    metrics = {}
    for m in manifest.metrics(bench, name, trace):
        v = manifest.reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": _number(float(v)), "limit": float(lim)}
              for k, (v, lim) in rec["checks"].items()}
    out = {"correct": bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if trace and rec.get("trace"):
        t = rec["trace"]
        out["device"] = dict(device, busy_s=t["busy_s"],
                             window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None, t_process: float = 0.0, root: Path = manifest.ROOT) -> int:
    args = parse_args(argv)
    try:
        bench = manifest.load(root)
        cell = manifest.workload(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not (Path(root) / "src" / "repro_torch").is_dir():
        print(f"portbench: the program (src/repro_torch) is not in {root}",
              file=sys.stderr)
        return 2
    set_environment(root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_process, "cuda", root)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = result(bench, args.workload, rec, bool(args.trace), device, root)
    for line in rec.get("diag", []):
        print(f"portbench: {line}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
