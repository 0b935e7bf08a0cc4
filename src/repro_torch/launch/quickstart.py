"""Quickstart: the paper's algorithm end to end on its own example CNN (the
port of ``examples/quickstart.py``).

    python -m repro_torch.launch.quickstart               # smoke widths, CUDA
    python -m repro_torch.launch.quickstart --device cpu  # on the CPU
    python -m repro_torch.launch.quickstart --full        # 50-80-120-200-350

Calibrates per-layer scales with a dense forward, builds the tables once
("done only once in the lifetime of a CNN"), runs inference through every
fetch path (gather, onehot, kernel, fused, and shared on extension-3 pools)
and checks each against direct multiplication on the same quantized
inputs (allclose at 1e-3).  Prints the paper's table-memory and build-cost
arithmetic for the configuration.  Without ``--device cpu`` it demands
CUDA and raises when there is none.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.paper_cnn import config, smoke_config
from repro_torch.core.pcilt import build_cost_multiplies, table_bytes
from repro_torch.interop import resolve_device

__all__ = ["PATHS", "run", "main"]

#: the fetch paths held against direct multiplication
PATHS = ("gather", "onehot", "kernel", "fused", "shared")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(full: bool = False, device="cuda", log=print) -> dict:
    """Build, run every path against DM on the reference quickstart's input
    (4 images of 16x16, values uniform in [0, 2), seeded); returns the
    logits by mode and the paper's arithmetic.  Raises if a path disagrees
    with DM."""
    dev = resolve_device(device)
    model = (config if full else smoke_config)(device=str(dev))
    log(f"paper CNN ({'published' if full else 'reduced'} widths): "
        f"channels={model.channels}, {model.k}x{model.k} filters, "
        f"INT{model.act_spec.bits} activations, on {dev}")
    params = model.init_params(0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.0, 2.0, (4, 16, 16, model.in_channels))
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        scales = model.calibrate(params, x)
        t0 = time.perf_counter()
        tables = model.build_tables(params, scales)
        _sync(dev)
        log(f"table build: {time.perf_counter() - t0:.3f}s")
        out = {"dm": model.forward(params, x, mode="dm", scales=scales)}
        for path in PATHS:
            t0 = time.perf_counter()
            # "shared" builds each layer's extension-3 pool in the forward
            got = model.forward(params, x, mode=path, scales=scales,
                                tables=None if path == "shared" else tables)
            _sync(dev)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       out["dm"].cpu().numpy(),
                                       rtol=1e-3, atol=1e-3)
            out[path] = got
            log(f"PCILT[{path:7s}] == DM  ✓   "
                f"({time.perf_counter() - t0:.3f}s)")
    n_w = sum(params[f"conv{i}"].numel() for i in range(len(model.channels)))
    mem = table_bytes(n_w, model.act_spec.bits, 2)
    mults = build_cost_multiplies(n_w, model.act_spec.bits)
    log(f"\nweights: {n_w}; PCILT memory {mem / 1e6:.2f} MB; "
        f"build multiplies {mults:,}")
    log("exactness: 'The PCILT values are an exact product of the "
        "convolutional function — there is no result precision loss.'")
    return {"logits": out, "n_weights": n_w, "table_bytes": mem,
            "build_multiplies": mults}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="the published widths (50-80-120-200-350)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.full, args.device)


if __name__ == "__main__":
    main()
