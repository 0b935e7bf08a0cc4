"""Training launcher (port of ``repro.launch.train``).

    python -m repro_torch.launch.train                   # smoke config, CUDA
    python -m repro_torch.launch.train --device cpu      # on the CPU
    python -m repro_torch.launch.train --full            # qwen3-0.6b, 28L
    python -m repro_torch.launch.train --arch granite-moe-3b-a800m --device cpu
    python -m repro_torch.launch.train --arch whisper-medium --device cpu
    python -m repro_torch.launch.train --arch llava-next-mistral-7b --seq 64 \
        --device cpu

Materializes seeded parameters, then runs the supervised train loop: AdamW
on a cosine schedule over the seeded synthetic corpus, a step watchdog,
async checkpoints every ``--ckpt-every`` steps, and a restore and replay
after a step fault (``--fail-at`` injects them).  With more than one CUDA
card visible the step runs data-parallel over a ``(data=n, model=1)``
mesh of them (placed parameters and state, the restore placing them
again), as the reference's does; on one card there is no mesh.  Batches are a pure
function of the step, so a run that restarts ends on the same parameters
as one that does not.  Runs on the card unless ``--device cpu``.  An MoE
config also logs its routers' load-balance and z losses; on the
``(data=n, model=1)`` mesh each data row routes its own tokens (the
all-to-all schedule with ``tp = 1``), as the reference's does.

The modality frontends are stubs, as the reference's: whisper's batches
carry ``memory`` (``encoder_len`` seeded frame embeddings), llava's
``img_embeds`` (``n_img_tokens`` seeded patch embeddings), and llava's
``--seq`` counts them, so its text is ``seq - n_img_tokens`` tokens (the
reference's slice of tokens, labels and mask); a ``--seq`` that leaves no
text is refused.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.interop import resolve_device, tree_map
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.nn.module import count_params, materialize, place, shardings
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_init_specs,
                               cosine_schedule)
from repro_torch.runtime import FaultInjector, Supervisor

__all__ = ["main", "parse_args", "run", "batch_source"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--full", action="store_true",
                   help="the full config (default: the smoke config)")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--fail-at", type=int, nargs="*", default=[],
                   help="inject step faults (fault-tolerance demo)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def batch_source(cfg, args):
    """``batch_for(step) -> {name: numpy array}``: the seeded corpus's
    batch of a step at ``args.seq`` and ``args.batch``, with the config's
    modality stubs (whisper's ``memory``, llava's ``img_embeds``); an
    image config's ``tokens``, ``labels`` and ``loss_mask`` cut to the
    ``args.seq - n_img_tokens`` text positions.  A pure function of the
    step.  Refuses a ``--seq`` that leaves no text."""
    text = args.seq - cfg.n_img_tokens
    if cfg.n_img_tokens and text <= 0:
        raise ValueError(
            f"--seq {args.seq} leaves no text after the {cfg.n_img_tokens} "
            f"image tokens of {cfg.name}: its loss is over the text; give "
            f"--seq above {cfg.n_img_tokens}")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch,
                       memory_len=cfg.encoder_len if cfg.encoder_layers
                       else 0,
                       img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)

    def batch_for(step):
        b = data.batch(step)
        if cfg.n_img_tokens:  # the image tokens take the front of --seq
            for k in ("tokens", "labels", "loss_mask"):
                b[k] = b[k][:, :text]
        return b

    return batch_for


def run(cfg, args, *, params=None, mesh=None) -> dict:
    """The supervised train loop of ``cfg`` as ``args`` set it up, from
    ``params`` (else parameters drawn from seed 0; the given tree is not
    changed, and a caller that keeps no other reference to it lets the
    first step free it).  The step runs on ``mesh`` when given (else on a
    ``(data=n, model=1)`` mesh of the CUDA cards when there are n > 1,
    else on the one device), the parameters and state placed on it, a
    restore placing them again.  Returns
    ``{"step", "params", "opt", "stats", "losses", "step_seconds",
    "setup_s"}``: ``losses`` and ``step_seconds`` hold one entry per step
    run (replayed steps again), each step synchronised by reading its
    loss."""
    dev = resolve_device(args.device)
    host_batch = batch_source(cfg, args)
    t_setup = time.perf_counter()
    model = build_model(cfg)
    specs = model.param_specs()
    if mesh is None:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = make_host_mesh(data=n_dev, model=1) if n_dev > 1 else None
    n_dev = 1 if mesh is None else mesh.devices.size
    print(f"arch={cfg.name} params={count_params(specs)/1e6:.2f}M "
          f"devices={n_dev} ({dev})")
    if params is None:
        params = materialize(specs, 0, device=dev)
    ocfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps),
                       weight_decay=0.01)
    placements = None
    if mesh is not None:  # data-parallel over the cards, as the reference
        placements = {"params": shardings(specs, mesh), "opt": {
            "count": None,
            **shardings({k: v for k, v in adamw_init_specs(specs, ocfg)
                         .items() if k != "count"}, mesh)}}
        params = place(params, placements["params"])
    opt_state = adamw_init(params, ocfg)
    step_fn = make_train_step(cfg, mesh, ocfg)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    injector = FaultInjector(args.fail_at)
    # the restore's tree structure (leaf names), without holding tensors
    skeleton = tree_map(lambda _: None, {"params": params, "opt": opt_state})
    losses, step_seconds = [], []

    def batch_for(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in host_batch(step).items()}

    def run_step(state, step):
        injector.maybe_fail(step)
        t0 = time.perf_counter()
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_for(step))
        losses.append(float(metrics["loss"]))
        step_seconds.append(time.perf_counter() - t0)
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            aux = (f" load_balance {m['load_balance']:.4f} router_z "
                   f"{m['router_z']:.4f}" if cfg.moe else "")
            print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}{aux}",
                  flush=True)
        return params, opt_state

    def save(state, step):
        ckpt.save_async(step, {"params": state[0], "opt": state[1]},
                        extra={"arch": cfg.name})

    def restore():
        got = ckpt.restore_latest(skeleton, placements, device=dev)
        if got[0] is None:
            return None
        step, tree, _ = got
        print(f"restored checkpoint at step {step}")
        return step, (tree["params"], tree["opt"])

    sup = Supervisor(step_fn=run_step, save_fn=save, restore_fn=restore,
                     ckpt_every=args.ckpt_every, max_restarts=3)
    setup_s = time.perf_counter() - t_setup
    t0 = time.time()
    state = (params, opt_state)
    del params, opt_state
    step, state, stats = sup.run(state, args.steps)
    ckpt.wait()
    print(f"done: {step} steps in {time.time()-t0:.1f}s; "
          f"restarts={stats['restarts']} "
          f"stragglers={stats['straggler_steps']}")
    return {"step": step, "params": state[0], "opt": state[1],
            "stats": stats, "losses": losses, "step_seconds": step_seconds,
            "setup_s": setup_s}


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)  # CUDA unless asked for the CPU
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    return run(cfg, args)


if __name__ == "__main__":
    main()
