"""The control of each cell, on the card at the cell's own size: the
reference in TF32 (the precision below the configurations' float32) in the
program's place must come out not correct, while the port in the same run
stays within its limits (the pending cells of ``portbench/pending/``
too).  Run with ``python -m pytest -m cuda
portbench/tests`` on a machine with an H100 (each case is a whole run:
set-up, a window of the benchmark's ``run_seconds``, the check)."""

import time

import pytest

from portbench import harness, manifest

from .smoke import merged

BENCH = merged(manifest.load())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_the_port_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell's own size)")
    harness.set_environment(manifest.ROOT)
    rec = harness.run_cell(BENCH, workload, 20261019, BENCH["run_seconds"],
                           False, time.perf_counter(), "cuda",
                           manifest.ROOT, "tf32")
    for name, (value, limit) in rec["checks"].items():
        assert value <= limit, (name, value, limit)
        assert rec["control"][name] > limit, (name, rec["control"], limit)
