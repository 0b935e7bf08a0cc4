"""PCILT quantized serving on an LM's MLP (the port of
``examples/serve_pcilt.py``).

    python -m repro_torch.launch.serve_pcilt               # on CUDA
    python -m repro_torch.launch.serve_pcilt --device cpu  # on the CPU

Converts layer 0's gated MLP (``wg``, ``wu``, ``wd``) of a seeded
qwen3-0.6b into grouped PCILTs offline (4-bit activations, group 2), then
computes the projections with table fetches instead of multiplies: the gate
through the ``gather``, ``onehot`` and ``kernel`` paths (``kernel``: the
host-packed GEMV, on CUDA tensors its device kernel), each against the
dense product on the quantized activation grid (1e-4), then the whole MLP.
Prints the table memory of one MLP layer at three widths.  ``run(cfg)``
takes any dense config (the smoke config by default; ``chip_smoke.py``
runs the published one).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.core import QuantSpec, calibrate, dequantize, quantize
from repro_torch.core.serving import convert_kernel, mlp_table_bytes
from repro_torch.interop import resolve_device
from repro_torch.models import build_model
from repro_torch.models.mamba import layer_view
from repro_torch.nn.module import materialize

__all__ = ["PATHS", "GROUP", "TOL", "run", "main"]

#: the fetch paths the gate projection is checked through
PATHS = ("gather", "onehot", "kernel")
GROUP = 2
#: the example's tolerance (float32 sums in another order)
TOL = 1e-4


def _check(what, got, want) -> float:
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        raise AssertionError(f"{what}: PCILT differs from the dense product "
                             f"on the quantized grid by {err:.3e}")
    return err


def run(cfg=None, device="cuda", seed=0, log=print) -> dict:
    """Convert and check; returns the converted gate (``"gate"``), layer
    0's MLP parameters (``"weights"``), the gate's input ``"x"``, each
    check's largest error and the table sizes printed.  Raises ``AssertionError`` on a check that
    fails."""
    dev = resolve_device(device)
    cfg = cfg or get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    params = materialize(model.param_specs(), seed, device=dev)
    spec = QuantSpec(bits=4)
    out = {"errors": {}}
    with torch.no_grad():
        # offline: convert layer 0's MLP kernels to PCILTs
        blk = layer_view(params["blocks"], 0)["sub0"]["mlp"]
        rng = np.random.default_rng(seed + 1)
        # post-norm activations are roughly symmetric; use |x|
        x = torch.from_numpy(np.abs(rng.standard_normal(
            (4, cfg.d_model), np.float32) * 0.5)).to(dev)
        s_in = calibrate(x, spec)
        lut_g = convert_kernel(blk["wg"]["kernel"], spec, s_in, GROUP)
        lut_u = convert_kernel(blk["wu"]["kernel"], spec, s_in, GROUP)

        # decode time: fetch instead of multiply
        xq = dequantize(quantize(x, spec, s_in), spec, s_in)
        want = xq @ blk["wg"]["kernel"]
        for path in PATHS:
            out["errors"][path] = _check(f"gate, path={path}",
                                         lut_g(x, path=path), want)
        log(f"MLP gate projection: PCILT({'|'.join(PATHS)}) == dense ✓ "
            f"(max |Δ| {max(out['errors'].values()):.2e})")

        h = F.silu(lut_g(x)) * lut_u(x)
        s_h = calibrate(h, spec)
        lut_d = convert_kernel(blk["wd"]["kernel"], spec, s_h, GROUP)
        hq = dequantize(quantize(h, spec, s_h), spec, s_h)
        out["errors"]["mlp"] = _check("full MLP", lut_d(h),
                                      hq @ blk["wd"]["kernel"])
        log("full MLP through PCILTs: exact on the quantized grid ✓ "
            f"(max |Δ| {out['errors']['mlp']:.2e})")

    # the memory story
    out["table_mib"] = {}
    widths = {cfg.name: (cfg.d_model, cfg.d_ff), "qwen3-0.6b": (1024, 3072),
              "deepseek-33b": (7168, 19200)}
    for label, (d, f) in widths.items():
        mb = mlp_table_bytes(d, f, act_bits=4, group=GROUP) / 2**20
        out["table_mib"][label] = mb
        log(f"table memory, {label:12s} MLP layer: {mb:10.1f} MiB "
            f"(INT4, g={GROUP})")
    log("→ big GEMMs need ext.3 shared tables or stay on the tensor cores; "
        "the fetch path earns its keep on conv frontends and narrow "
        "projections.")
    out.update(gate=lut_g, weights=blk, x=x)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
