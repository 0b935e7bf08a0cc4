"""Full-PCILT Mamba decode: calibrate -> convert_mamba_decode -> prefill ->
generate (the port of ``examples/decode_pcilt.py``).

    python -m repro_torch.launch.decode_pcilt               # on CUDA
    python -m repro_torch.launch.decode_pcilt --device cpu  # on the CPU

One offline conversion of mamba2-130m's smoke config at 2-bit activations,
group 2 (a calibration pass, the per-layer conv ``[L, C, V]`` tables and
the layer-stacked ``[L, G, V, O]`` projection tables), a 16-token prompt
prefilled by ``MambaLM.prefill``, then greedy steps in which the conv
frontend and all six projections of every layer are table fetches (on CUDA
tensors, the fused depthwise conv and the stacked GEMV kernels).  Ends by
checking the fetch step against the dense fake-quant oracle (2e-4).  After
the conversion ``eng.tune(batch=1)`` records the kernels' designs for this
decode shape in the design cache (``kernels.autotune``; timed on the card,
a lookup on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PCILTConfig
from repro_torch.core.serving import convert_mamba_decode
from repro_torch.interop import resolve_device
from repro_torch.models import build_model
from repro_torch.nn.module import materialize

__all__ = ["TOL", "run", "main"]

#: the oracle check's tolerance (float32 sums in another order)
TOL = 2e-4


def run(steps: int = 8, device="cuda", seed=0, log=print) -> dict:
    """Convert, prefill, generate and check; returns the tokens, the
    oracle check's largest error, and the parameters, calibration tokens
    and prompt it drew from ``seed``.  Raises ``AssertionError`` when the
    fetch step differs from the oracle."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=2, group=2),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = materialize(model.param_specs(), seed, device=dev)
    rng = np.random.default_rng(seed)
    calib = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)))

    with torch.no_grad():
        # offline: calibrate and build every table
        eng = convert_mamba_decode(model, params, calib, device=dev)
        eng.tune(batch=1)  # record the kernels' designs for this shape
        n_proj = len(eng.pcilt["proj"]["tables"])
        log(f"converted {cfg.n_layers} layers: conv tables "
            f"{tuple(eng.pcilt['tables'].shape)} + {n_proj} stacked "
            f"projection tables; {eng.table_bytes() / 2**20:.2f} MiB total")

        # generate: prefill the prompt, then greedy full-PCILT decode
        logits, cache = model.prefill(params, {"tokens": prompt.to(dev)})
        tok = logits.argmax(-1)[:, None]
        tokens = [int(tok[0, 0])]
        for _ in range(steps - 1):
            logits, cache = eng.step(params, cache, tok)
            tok = logits.argmax(-1)[:, None]
            tokens.append(int(tok[0, 0]))
        log(f"greedy full-PCILT decode, {steps} steps: {tokens}")

        # exactness on the quantized grid
        oracle = dict(eng.pcilt, proj=dict(eng.pcilt["proj"],
                                           path="dense_fq"))
        l_fetch, _ = eng.step(params, cache, tok)
        l_oracle, _ = model.decode_step(params, cache, tok, pcilt=oracle)
    err = float((l_fetch - l_oracle).abs().max())
    if not torch.allclose(l_fetch, l_oracle, rtol=TOL, atol=TOL):
        raise AssertionError(f"the stacked table fetch differs from the "
                             f"fake-quant dense oracle by {err:.2e}")
    log(f"stacked table fetch == fake-quant dense oracle ✓ (max |Δ| = "
        f"{err:.2e})")
    return {"tokens": tokens, "max_abs_err": err, "params": params,
            "calib": calib, "prompt": prompt}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
