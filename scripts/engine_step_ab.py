#!/usr/bin/env python3
"""The full-width mamba2-130m PCILT engine's decode step, for several
checkouts of the port in one run on one card.

    python3 scripts/engine_step_ab.py TREE [TREE ...] [--out FILE]

Each ``TREE`` is the root of a checkout (its ``src/repro_torch`` is
imported, its kernels built from its own sources into its own ``build/``).
The trees run one after another, each in a subprocess of its own, in the
order given: give ``parent change change parent`` to compare two versions
on one machine.  A child builds ``Engine(get_config("mamba2-130m"),
slots=4, pcilt=True, seed=0, device="cuda")`` at 4 bits, group 2, float32
(as ``chip_smoke.py`` phase 5), serves the same 4 requests of 8 new tokens
``RUNS`` times, and prints one JSON line: its set-up seconds and, for each
run, the median of the engine's ``step_seconds`` (host seconds of one
decode step, its device->host read included), the run's wall seconds per
step, and the caching allocator's device allocations (``cudaMalloc``) and
retries after freeing its cache during the run.  The parent prints the
card's name and power limit, every child's line, and one JSON object with
all of them (also written to ``--out``)."""

import json
import os
import statistics
import subprocess
import sys
import time

RUNS = 3


def child(tree: str) -> dict:
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.launch.serve import Engine, make_requests

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=4, pcilt=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"tree": tree, "setup_s": time.perf_counter() - t0, "runs": []}
    for _ in range(RUNS):
        n0 = len(eng.step_seconds)
        mem0 = torch.cuda.memory_stats()
        stats = eng.run(make_requests(cfg, 4, 8, seed=0))
        mem = torch.cuda.memory_stats()
        steps = eng.step_seconds[n0:]
        out["runs"].append({
            "median_step_s": statistics.median(steps), "steps": len(steps),
            "wall_s_per_step": stats["wall_s"] / len(steps),
            "device_allocs": mem.get("num_device_alloc", 0)
            - mem0.get("num_device_alloc", 0),
            "alloc_retries": mem.get("num_alloc_retries", 0)
            - mem0.get("num_alloc_retries", 0)})
    return out


def main(argv) -> int:
    if argv and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    for tree in argv:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        line = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        results.append(line)
    report = {"card": card, "results": results}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
