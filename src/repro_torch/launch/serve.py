"""Serving engine (port of the closed-loop core of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch mamba2-130m --full --pcilt``
serves a few seeded requests through the converted full-PCILT decode on
the card (``--device cpu`` runs the plain versions on the CPU instead).

Engine: a fixed decode batch of slots; requests queue in, a free slot
prefills its request by replaying the prompt through the decode step
(concurrently active slots keep generating), every tick decodes the whole
batch greedily, finished slots are zeroed and recycled.  Before a step is
committed its logits and every cache tensor must be finite.  With
``sentinel`` (the default for PCILT) the steps return the in-kernel
saturation counters, which the engine keeps.

Still to port: the health monitor, the checkpoint ring with restore and
rollback, deadlines, admission control and traffic, chaos and
``--no-sentinel``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.serving import PCILTMambaDecode, convert_mamba_decode
from repro_torch.interop import resolve_device
from repro_torch.models import build_model
from repro_torch.nn.module import materialize

__all__ = ["Request", "Engine", "make_requests", "main"]

#: every request ends in exactly one of these (this slice serves or fails)
OUTCOMES = ("served", "failed")


class Request:
    def __init__(self, rid: int, prompt, max_new: int):
        self.rid = rid
        self.prompt = np.asarray(prompt)
        self.max_new = max_new
        self.out: List[int] = []
        self.done = False
        #: queued | active | served | failed
        self.outcome = "queued"


class Engine:
    """Slot-based continuous batching over the (PCILT) Mamba decode step.

    ``params`` / ``pcilt_bundle`` carry in existing weights and tables (the
    parity tests hand over the JAX package's); otherwise parameters are
    drawn from ``seed`` and, with ``pcilt``, converted on calibration tokens
    drawn from ``seed + 2``."""

    def __init__(self, cfg, slots: int = 4, *, pcilt: bool = False,
                 params=None, pcilt_bundle: Optional[Dict] = None,
                 sentinel: bool = True, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.slots = slots
        self.params = params if params is not None else materialize(
            self.model.param_specs(), seed, self.device)
        self.cache = materialize(self.model.cache_specs(slots), seed,
                                 self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.tokens = np.zeros((slots, 1), np.int64)
        self.queue: List[Request] = []
        self.tick = 0
        self.prefill_ticks = 0
        #: host seconds of every step, synchronised (the argmax is read back)
        self.step_seconds: List[float] = []
        #: seconds of each conversion phase (calibrate, build, CRC, verify)
        self.convert_timings: Dict[str, float] = {}
        self.pdecode = None
        self.sentinel = bool(sentinel) and pcilt
        self.last_sat = None
        self.sat_counts: Dict[str, torch.Tensor] = {}
        if pcilt:
            if cfg.pcilt is None:
                raise ValueError("Engine(pcilt=True) requires cfg.pcilt (a "
                                 "configs.base.PCILTConfig)")
            if pcilt_bundle is not None:
                self.pdecode = PCILTMambaDecode(self.model, pcilt_bundle)
            else:
                rng = np.random.default_rng(seed + 2)
                calib = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
                self.pdecode = convert_mamba_decode(
                    self.model, self.params, calib, head="shared",
                    timings=self.convert_timings, device=self.device)

    # -- stepping ------------------------------------------------------------

    def _raw_step(self):
        toks = torch.from_numpy(self.tokens).to(self.device)
        if self.pdecode is None:
            return self.model.decode_step(self.params, self.cache, toks)
        if self.sentinel:
            logits, new_cache, sat = self.pdecode.step(
                self.params, self.cache, toks, with_stats=True)
            self.last_sat = sat
            for grid, st in sat.items():  # accumulated on the device
                acc = self.sat_counts.get(grid)
                self.sat_counts[grid] = st["count"].long() if acc is None \
                    else acc + st["count"]
        else:
            logits, new_cache = self.pdecode.step(self.params, self.cache, toks)
        if self.cfg.padded_vocab > self.cfg.vocab:  # never sample padding
            logits[..., self.cfg.vocab:] = -1e30
        return logits, new_cache

    def _step(self) -> np.ndarray:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, new_cache = self._raw_step()
            # finite gate before the commit: logits and the recurrent state
            # (quantization launders NaN into a valid lookup, so poisoned
            # state can yield finite logits)
            checks = [torch.isfinite(logits).all()]
            checks += [torch.isfinite(t).all()
                       for t in new_cache["layers"].values()]
            ok = torch.stack(checks).all()
            # one device->host read for the sampled tokens and the gate
            nxt = torch.cat([logits.argmax(-1), ok.long()[None]]).cpu().numpy()
        self.step_seconds.append(time.perf_counter() - t0)
        if not nxt[-1]:
            raise RuntimeError("non-finite decode outputs or state (NaN/Inf)")
        self.cache = new_cache
        return nxt[:-1]

    def _prefill_into_slot(self, slot: int, req: Request):
        """Feed the prompt through decode steps (teacher-forced prefill);
        concurrently active slots commit the tokens they generate meanwhile,
        and the step that consumes the last prompt token emits the
        request's first token."""
        req.outcome = "active"
        self._reset_slot(slot)  # an idle slot stepped with the batch
        last = 0
        for t in req.prompt:
            self.tokens[slot, 0] = int(t)
            out = self._step()
            self.prefill_ticks += 1
            self._commit_tokens(out, skip=slot)
            last = int(out[slot])
        self.active[slot] = req
        req.out.append(last)
        self.tokens[slot, 0] = last
        self._finish_if_done(slot)

    def _commit_tokens(self, nxt, skip: Optional[int] = None):
        for s, req in enumerate(self.active):
            if req is None or s == skip:
                continue
            tok = int(nxt[s])
            req.out.append(tok)
            self.tokens[s, 0] = tok
            self._finish_if_done(s)

    def _finish_if_done(self, s: int):
        req = self.active[s]
        if req is not None and len(req.out) >= req.max_new:
            req.done = True
            req.outcome = "served"
            self.active[s] = None
            self._reset_slot(s)

    def _reset_slot(self, s: int):
        """Zero one slot's recurrent state so a recycled slot never leaks a
        previous request's context into the next."""
        for t in self.cache["layers"].values():
            t[:, s] = 0

    # -- main loop -----------------------------------------------------------

    def run(self, requests: List[Request]) -> Dict:
        """Serve every request (all offered at once, FIFO into free slots)."""
        self.queue = list(requests)
        for r in requests:
            r.outcome = "queued"
        t0 = time.perf_counter()
        self.tick = 0
        self.prefill_ticks = 0
        while self.queue or any(r is not None for r in self.active):
            for s in range(self.slots):
                if self.active[s] is None and self.queue:
                    self._prefill_into_slot(s, self.queue.pop(0))
            if not any(r is not None for r in self.active):
                continue
            nxt = self._step()
            self._commit_tokens(nxt)
            self.tick += 1
        outcomes = {r.rid: r.outcome for r in requests}
        stats = {
            "decode_ticks": self.tick,
            "prefill_ticks": self.prefill_ticks,
            "wall_s": time.perf_counter() - t0,
            "offered": len(requests),
            "served": sum(o == "served" for o in outcomes.values()),
            "outcomes": outcomes,
            "table_bytes": (self.pdecode.table_bytes()
                            if self.pdecode is not None else 0),
        }
        if self.sentinel:
            stats["saturation"] = {g: c.cpu().tolist()
                                   for g, c in self.sat_counts.items()}
        return stats


def make_requests(cfg, n: int, max_new: int, seed: int) -> List[Request]:
    """Seeded prompts of 4..11 tokens (the reference engine's stream)."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(2, cfg.vocab, size=rng.integers(4, 12)),
                    max_new) for i in range(n)]


def main(argv=None):
    import dataclasses

    from repro_torch.configs.base import PCILTConfig

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-130m")
    p.add_argument("--full", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--pcilt", action="store_true",
                   help="serve the converted full-PCILT decode path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.pcilt:
        cfg = dataclasses.replace(cfg, pcilt=PCILTConfig(act_bits=4, group=2),
                                  dtype=torch.float32)
    eng = Engine(cfg, slots=args.slots, pcilt=args.pcilt, seed=args.seed,
                 device=args.device)
    reqs = make_requests(cfg, args.requests, args.max_new, args.seed)
    stats = eng.run(reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> {r.out[:8]} "
              f"[{r.outcome}]")
    print(f"served {stats['served']} requests in {stats['wall_s']:.2f}s "
          f"({stats['decode_ticks']} decode ticks, "
          f"{stats['prefill_ticks']} prefill ticks)")


if __name__ == "__main__":
    main()
