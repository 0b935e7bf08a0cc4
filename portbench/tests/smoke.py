"""A copy of the benchmark at smoke sizes for the CPU tests: the same files
with the widths, depths, images and prompts cut, so a whole run (set-up,
window, check) takes seconds on the CPU through the port's plain
versions."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import manifest

CNN = dict(channels=[8, 12], act_bits=2)
MAMBA = dict(n_layers=2, d_model=64, vocab=256, d_state=16, head_dim=16,
             chunk=16, calibration_tokens=[2, 16])
FRAMES = dict(shape=[1, 24, 32, 1])
CHAT = dict(prompt_tokens=[2, 6], output_tokens=[2, 6], queued=64)
#: at smoke size on the CPU the port's decode equals the reference to
#: float32 rounding (its mean gap ~1e-7, against 0.04-0.42 at full size on
#: the card, where 4-bit requantization in the recurrent state amplifies
#: rounding); the copy's limit sits that far lower, so a fault that spoils
#: a share of the tokens reads above it as it does above 1.2 at full size
DECODE_LIMIT = 1e-3


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def merged(bench: dict) -> dict:
    """``bench`` with the cells of ``portbench/pending/`` added (built and
    proven, not yet benchmarked): each group's entries appended, and each
    pending cell among ``convert_s``'s workloads."""
    out = json.loads(json.dumps(bench))
    for path in sorted((manifest.HERE / "pending").glob("*.json")):
        extra = json.loads(path.read_text())
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            out[group] += extra[group]
        for m in out["per_layer"]:
            if m["name"] == "convert_s":
                m["workloads"] += [w["name"] for w in extra["workloads"]]
    return out


def make(dest: Path) -> Path:
    """``dest`` as a checkout: ``BENCHMARK.json`` with the pending cells,
    ``portbench/`` at smoke sizes, and ``src`` linked to the port's
    sources."""
    dest = Path(dest)
    shutil.copytree(manifest.HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "BENCHMARK.json").write_text(json.dumps(merged(manifest.load())))
    (dest / "src").symlink_to(manifest.ROOT / "src")
    pb = dest / "portbench"
    _edit(pb / "configs" / "paper-cnn.json", **CNN)
    _edit(pb / "configs" / "mamba2-130m-pcilt4.json", **MAMBA)
    _edit(pb / "traffic" / "frames-1024x768.json", **FRAMES)
    _edit(pb / "traffic" / "chat-closed-16-96x16-64.json", **CHAT)
    lim = pb / "limits" / "mamba-decode-4slots.json"
    data = json.loads(lim.read_text())
    data["numbers"]["token_gap_mean"]["limit"] = DECODE_LIMIT
    lim.write_text(json.dumps(data))
    return dest


def run(root: Path, workload: str, seed: int = 20261018,
        seconds: float = None, trace: bool = False):
    """One run of ``workload`` from the copy at ``root`` on the CPU, the
    harness's look for a card skipped: ``(record, result line)``."""
    import os
    import sys

    from portbench import harness

    bench = manifest.load(root)
    env, path = dict(os.environ), list(sys.path)
    harness.set_environment(root)
    if seconds is None:  # the decode needs a few requests finished
        seconds = 6.0 if workload.startswith("mamba") else 1.0
    try:
        rec = harness.run_cell(bench, workload, seed, seconds, trace, 0.0,
                               "cpu", root)
    finally:  # the tests that share this process keep their environment
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    return rec, harness.result(bench, workload, rec, trace, dev, root)
