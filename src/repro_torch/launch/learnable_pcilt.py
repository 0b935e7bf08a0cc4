"""Extension 4, "Using PCILTs as Weights": train table entries directly (the
port of ``examples/learnable_pcilt.py``).

    python -m repro_torch.launch.learnable_pcilt               # on CUDA
    python -m repro_torch.launch.learnable_pcilt --device cpu  # on the CPU

Fits a small regression (16 inputs, 4 outputs, 64 seeded samples, 2-bit
activations, group 2) at each of the paper's four adjustment granularities
with 150 steps of SGD (learning rate 0.03) over every parameter, ``base``
included; then serves each trained table through the host-packed GEMV
kernel (``path="kernel"`` under ``torch.no_grad()``) against the gather
path it trained on, and rebuilds classic filters from the entry-trained
tables by least squares.  Without ``--device cpu`` it demands CUDA and
raises when there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (QuantSpec, apply_learnable_pcilt, calibrate,
                              effective_tables, extract_filters,
                              init_learnable_pcilt)
from repro_torch.core.learnable import GRANULARITIES
from repro_torch.interop import resolve_device

__all__ = ["N_IN", "N_OUT", "BATCH", "STEPS", "LR", "run", "main"]

N_IN, N_OUT, BATCH, GROUP = 16, 4, 64, 2
STEPS, LR = 150, 0.03


def run(device="cuda", log=print) -> dict:
    """Train every granularity; returns the losses before and after, each
    trained table's kernel-path error against the gather path and the
    filter reconstruction's error."""
    dev = resolve_device(device)
    spec = QuantSpec(bits=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.normal(size=(BATCH, N_IN)))
                         .astype(np.float32)).to(dev)
    w_true = torch.from_numpy(rng.normal(size=(N_IN, N_OUT))
                              .astype(np.float32)).to(dev)
    y = x @ w_true
    scale = float(calibrate(x, spec))
    # the random base tables (drawn with numpy, so the CPU and the card
    # train the same ones), shared by every granularity
    w0 = torch.from_numpy((rng.normal(size=(N_IN, N_OUT)) / N_IN ** 0.5)
                          .astype(np.float32)).to(dev)

    def loss(p):
        return torch.mean((apply_learnable_pcilt(p, x, spec, scale, GROUP)
                           - y) ** 2)

    out = {"device": str(dev), "losses": {}, "kernel_max_abs_err": {}}
    for gran in GRANULARITIES:
        params = init_learnable_pcilt(None, N_IN, N_OUT, spec, scale, GROUP,
                                      granularity=gran, base_weights=w0)
        l0 = loss(params).item()
        for _ in range(STEPS):
            grads = torch.autograd.grad(loss(params), list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p -= LR * g
        l1 = loss(params).item()
        with torch.no_grad():
            served = apply_learnable_pcilt(params, x, spec, scale, GROUP,
                                           path="kernel")
            trained = apply_learnable_pcilt(params, x, spec, scale, GROUP)
        err = float((served - trained).abs().max())
        out["losses"][gran] = (l0, l1)
        out["kernel_max_abs_err"][gran] = err
        log(f"granularity={gran:7s}  loss {l0:8.4f} -> {l1:8.4f}   (params "
            f"adjusted: {[k for k in params if k != 'base']}; kernel path "
            f"vs gather {err:.2e})")
    with torch.no_grad():
        w_rec = extract_filters(effective_tables(params), spec, scale, GROUP)
        err = float(torch.mean((x @ w_rec - apply_learnable_pcilt(
            params, x, spec, scale, GROUP)) ** 2))
    out["filter_mse"] = err
    log(f"\nfilters rebuilt from tables: surrogate-DM vs LUT mse={err:.5f} "
        "(exact when tables stay in the product manifold; the residual is "
        "the extra expressivity per-entry training bought)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
