"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
(the port of ``examples/train_lm.py``).

The qwen3 family at a ~100M reduced width on the synthetic corpus with the
full substrate: AdamW on a cosine schedule, packed and masked data, the
step watchdog and async checkpoints.

    python -m repro_torch.launch.train_lm [--steps 300]        # on CUDA
    python -m repro_torch.launch.train_lm --device cpu          # on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.interop import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.nn.module import count_params, materialize
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.runtime import StepWatchdog

__all__ = ["config_100m", "main"]


def config_100m():
    base = get_smoke_config("qwen3-0.6b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=32000, head_dim=64,
        tie_embeddings=True, loss_chunk=0,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "repro_torch_train_lm"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    model = build_model(cfg)
    specs = model.param_specs()
    print(f"training {cfg.name}: {count_params(specs)/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} synthetic tokens")

    params = materialize(specs, 0, device=dev)
    ocfg = AdamWConfig(lr=cosine_schedule(1e-3, 20, args.steps),
                       weight_decay=0.01)
    opt = adamw_init(params, ocfg)
    step_fn = make_train_step(cfg, None, ocfg)

    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    watchdog = StepWatchdog()

    losses = []
    t_start = time.time()
    for step in range(args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        watchdog.observe(step, time.time() - t0)
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"lr {float(m['lr']):.2e}", flush=True)
        if step and step % 100 == 0:
            ckpt.save_async(step, {"params": params, "opt": opt})
    ckpt.wait()
    dt = time.time() - t_start
    toks = args.steps * args.batch * args.seq
    print(f"\ndone in {dt:.1f}s ({toks/dt:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers flagged: {watchdog.flagged}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training must reduce loss: {losses}")
    return losses


if __name__ == "__main__":
    main()
