"""Serving engine, hardened for faults and load (port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve`` serves seeded requests on qwen3-0.6b
(the smoke config; ``--full`` for the published one) through the dense
decode step with its KV cache; ``--arch mamba2-130m --pcilt`` serves
through the converted full-PCILT Mamba decode on the card (``--device
cpu`` runs the plain versions on the CPU instead).  ``--traffic poisson``
drives the same engine open-loop on a virtual clock.

Engine: a fixed decode batch of slots; requests queue in, a free slot
prefills its request by replaying the prompt through the decode step
(concurrently active slots keep generating), every tick decodes the whole
batch greedily, finished slots are zeroed and recycled.  The dense
transformer's KV cache has one write position for all slots (``pos``,
as the reference's): it is not reset with a slot, so a recycled slot's
request starts at the current ``pos`` and attends to the zeroed rows
before it, as the reference's does.  With ``--pcilt``
the decode runs under a :class:`repro_torch.core.serving.HealthMonitor`:
one layer's tables are CRC'd a tick (on the card, by the CRC kernel), and
a breached layer is demoted to its exact dense fake-quant oracle.

Resilience contract:

* **tick-level try/restore** — every committed tick checkpoints the engine
  state (cache, tokens, slots, queue, pending arrivals, request fields)
  into a bounded ring; any step fault restores the latest checkpoint and
  replays, up to ``max_restarts``.  Tensors change in place (a slot reset
  writes zeros into the cache), so a checkpoint holds a clone of the
  cache and a restore hands out another clone: a second restore to the
  same snapshot finds it whole;
* **never wrong** — a table breach found at tick ``k`` may have poisoned
  commits back to the layer's ``last_verified`` tick, so the engine rolls
  back there and replays with the layer demoted; drift indicts only the
  current tick;
* **deadlines** — a request past ``deadline_s`` is evicted, its slot
  zeroed, and requeued with exponential backoff up to ``max_retries``
  times, then failed;
* **watchdog** — tick times feed a :class:`repro_torch.runtime.StepWatchdog`;
* **accounting** — every request ends in exactly one outcome (``served``
  / ``degraded`` / ``failed`` / ``rejected``), read from request state at
  the end, so replays never double-count.

Overload contract: ``queue_limit`` sheds at admission (typed
``rejected``), as does a deadline the backlog already makes unmeetable;
free slots take the queued request with the earliest deadline (EDF, FIFO
ties); a request past its deadline while queued is evicted there; every
tick appends a telemetry record.  All time flows through an injectable
``clock`` (default :class:`repro_torch.runtime.WallClock`); a
:class:`repro_torch.runtime.VirtualClock` with ``step_cost_s`` makes every
deadline, backoff and arrival path deterministic.

``--chaos`` drives the engine through the injected fault classes
(garbled design cache, scheduled step fault, NaN-poisoned state, corrupted
projection stack, flipped head pointers) and exits non-zero if a request is lost or the
undegraded tokens differ from a fault-free run; ``--chaos --traffic ...``
composes both contracts.  ``--chaos-drift`` moves one layer's activations
off their calibrated range and requires detect -> demote -> recalibrate ->
repromote.  ``--no-sentinel`` serves without the in-kernel saturation
counters.

The MoE family (granite-moe-3b-a800m, llama4-maverick-400b-a17b) serves
through the same dense decode step.  The hybrid family (zamba2-7b) does not
serve here, as it does not in the reference (see :class:`Engine`).  The
CLI refuses whisper-medium and llava-next-mistral-7b with the reference's
message; the :class:`Engine` serves them as the reference's does.  A
bundle with tables sharded over a mesh (``convert_mamba_decode(...,
mesh=)``) is served through ``pcilt_bundle=``, as in the reference;
``--chaos``'s table fault then flips one shard in place.  The CLI has no
mesh flag, as the reference's has none.

``Engine(cfg, max_len, slots, mesh)`` serves on a mesh (``launch.mesh``:
CPU devices in the tests, ``cuda:0`` repeated or D cards on the GPU): the
parameters and the cache are placed by ``nn.module.shardings`` (a
replicated leaf held once per distinct device), every device's bytes are
checked against the partition specs, and the steps run the layers'
per-shard bodies (``nn.layers.Ctx``); a slot reset, the checkpoint ring,
a restore and a rollback work on the placed blocks.  With ``pcilt`` the
converted Mamba decode runs under ``make_ctx(mesh, None, decode=True)``.
An MoE config serves on a mesh too: its experts are cut over ``"model"``
(and their ``embed`` dim over ``"data"``), each device's expert blocks
checked with the rest, and every decode step (one token a slot) takes
``nn.moe``'s psum schedule.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.serving import (HealthMonitor, PCILTMambaDecode,
                                      convert_mamba_decode)
from repro_torch.interop import resolve_device, tree_leaves, tree_map
from repro_torch.launch.steps import make_ctx, make_decode_step
from repro_torch.models import build_model
from repro_torch.nn.module import (Placed, check_placed_bytes,
                                   fallback_leaves, materialize, place,
                                   shardings)
from repro_torch.runtime import StepWatchdog, WallClock

log = logging.getLogger("repro_torch.serve")

__all__ = ["OUTCOMES", "Request", "Engine", "make_requests", "token_latencies",
           "verify_accounting", "DRIFT_LAYER", "DRIFT_GAMMA", "DRIFT_STEP",
           "parse_args", "run_cli", "main"]

#: every request ends in exactly one of these
OUTCOMES = ("served", "degraded", "failed", "rejected")


class _Degraded(Exception):
    """Health breach: roll back to ``target_tick`` and replay demoted."""

    def __init__(self, target_tick: int, events):
        super().__init__(f"health breach; replay from tick {target_tick}")
        self.target_tick = target_tick
        self.events = events


class Request:
    def __init__(self, rid: int, prompt, max_new: int,
                 deadline_s: Optional[float] = None, max_retries: int = 2):
        self.rid = rid
        self.prompt = np.asarray(prompt)
        self.max_new = max_new
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.out: List[int] = []
        self.done = False
        #: queued | active | served | degraded | failed | rejected
        self.outcome = "queued"
        self.retries = 0
        #: True when any committed token was produced under demotion
        self.degraded = False
        self.t_arrive = 0.0  # when the request reached the engine (clock)
        self.t_enqueue = 0.0  # start of the current queued attempt
        self.t_admit = 0.0  # when the current attempt's prefill began
        self.t_done = 0.0  # when a terminal outcome was assigned
        self.not_before = 0.0  # backoff gate of a requeued request


def _clone(a):
    return a.clone() if torch.is_tensor(a) or isinstance(a, Placed) else a


def _float_blocks(tree):
    """The floating tensors of a cache tree, a placed leaf's distinct
    blocks each."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, Placed):
            out += [b for _, b in t.unique() if b.is_floating_point()]
        elif torch.is_tensor(t) and t.is_floating_point():
            out.append(t)
    return out


class Engine:
    """Slot-based continuous batching over a model's decode step (the
    dense transformer's with its ``max_len`` KV cache, Mamba's, or the
    converted PCILT Mamba step), with checkpointed fault recovery and
    bounded-admission overload control.

    ``params`` / ``pcilt_bundle`` carry in existing weights and tables (the
    parity tests hand over the JAX package's); otherwise parameters are
    drawn from ``seed`` and, with ``pcilt``, converted on calibration tokens
    drawn from ``seed + 2``.

    The hybrid family is refused: the reference's ``Engine._reset_slot``
    reads ``cache["layers"]``, which ``HybridLM.cache_specs`` does not
    have (``{"ssm", "attn", "pos"}``), so the JAX engine fails with a
    ``KeyError`` at its first slot reset; the port raises at
    construction instead.  Hybrid models run through their ``prefill`` and
    ``decode_step`` and the trainer.

    The audio and vlm families serve as the reference's engine serves
    them, text only: whisper decodes against the all-zero ``cross_kv`` of
    ``cache_specs`` (no encoder runs: its cross-attention adds nothing),
    and llava's requests carry no image.  A checkpoint clones the whole
    cache, ``cross_kv`` included; a slot reset zeroes ``cache["layers"]``
    only.  The CLI (:func:`main`) refuses both families, as the
    reference's does.

    With ``mesh`` (a ``launch.mesh.Mesh``) the parameters and cache are
    placed by ``nn.module.shardings`` and checked byte for byte against
    the partition specs (an MoE config's expert leaves among them) and
    ``self.device`` is the mesh's first device."""

    def __init__(self, cfg, max_len: int = 256, slots: int = 4, mesh=None, *,
                 pcilt: bool = False,
                 params=None, pcilt_bundle: Optional[Dict] = None,
                 oracle_every: int = 4, max_restarts: int = 8,
                 ckpt_keep: Optional[int] = None,
                 chaos: Optional[Dict] = None, clock=None,
                 queue_limit: Optional[int] = None,
                 step_cost_s: Optional[float] = None, sentinel: bool = True,
                 seed: int = 0, device="cuda"):
        if cfg.family == "hybrid":
            raise NotImplementedError(
                "the hybrid family does not serve through the Engine: the "
                "reference's Engine._reset_slot reads cache['layers'], which "
                "HybridLM.cache_specs lacks ({'ssm', 'attn', 'pos'}); use "
                "the model's prefill and decode_step")
        #: the mesh the engine serves on (``launch.mesh.Mesh``) or None;
        #: with one, the parameters and cache are placed by
        #: ``nn.module.shardings`` and ``self.device`` is its first device
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else \
            resolve_device(mesh.devices.reshape(-1)[0])
        self.cfg = cfg
        self.model = build_model(cfg)
        self.slots = slots
        self.max_restarts = max_restarts
        #: time source (``.time()`` / ``.sleep(s)``)
        self.clock = clock if clock is not None else WallClock()
        #: bounded admission queue (None: unbounded)
        self.queue_limit = queue_limit
        #: simulated service time a step advances the clock by (None: real)
        self.step_cost_s = step_cost_s
        # with a mesh the whole tree is drawn on the host and placed block
        # by block (a PCILT conversion reads it whole on the card first)
        home = self.device if mesh is None or pcilt else torch.device("cpu")
        self.params = params if params is not None else materialize(
            self.model.param_specs(), seed, device=home)
        self.cache = materialize(self.model.cache_specs(slots, max_len),
                                 seed, device=self.device if mesh is None
                                 else torch.device("cpu"))
        if "pos" in self.cache:  # the KV cache's write position, on the host
            self.cache["pos"] = 0
        self.decode = make_decode_step(cfg, mesh)
        #: the logical dims the divisibility fallback replicates on the mesh
        self.replicated_leaves: List[str] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.tokens = np.zeros((slots, 1), np.int64)
        #: chaos schedule {step count: [fn(engine)]} keyed on the monotone
        #: ``self.steps`` (never rewound by a restore); entries fire once
        self.chaos = dict(chaos or {})
        self.ckpts: deque = deque(maxlen=ckpt_keep or (int(cfg.n_layers) + 4))
        self.queue: List[Request] = []
        self._requests: List[Request] = []
        self._pending: List[Tuple[float, Request]] = []
        self.tick = 0
        self.steps = 0  # monotone prefill + decode step count (chaos clock)
        self.prefill_ticks = 0
        self.restarts = 0
        self.rollbacks = 0
        self.queue_evictions = 0
        self.slot_evictions = 0
        self.telemetry: List[Dict] = []
        self._tick_ema: Optional[float] = None
        #: host seconds of every step, synchronised (the argmax is read back)
        self.step_seconds: List[float] = []
        #: seconds of each conversion phase (calibrate, build, CRC, verify)
        self.convert_timings: Dict[str, float] = {}
        self.pdecode = None
        self.monitor = None
        #: the drift sentinel: PCILT steps return their saturation counters
        #: (``sentinel=False`` serves without them)
        self.sentinel = bool(sentinel) and pcilt
        #: the last step's counters, on the host
        self._last_sat = None
        if pcilt:
            if cfg.pcilt is None:
                raise ValueError("Engine(pcilt=True) requires cfg.pcilt (a "
                                 "configs.base.PCILTConfig)")
            ctx = make_ctx(mesh, None, decode=True)
            if pcilt_bundle is not None:
                self.pdecode = PCILTMambaDecode(self.model, pcilt_bundle,
                                                ctx=ctx)
            else:
                rng = np.random.default_rng(seed + 2)
                calib = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
                self.pdecode = convert_mamba_decode(
                    self.model, self.params, calib, ctx=ctx, head="shared",
                    timings=self.convert_timings, device=self.device)
        if mesh is not None:
            self._place(max_len)
        if pcilt:
            self.monitor = HealthMonitor(self.pdecode, self.params,
                                         oracle_every=oracle_every)

    def _place(self, max_len: int):
        """Place the whole parameter and cache trees on the mesh by
        ``shardings`` and check every device's bytes against the partition
        specs (raising on a difference)."""
        rules = make_ctx(self.mesh).rules
        pspecs = self.model.param_specs()
        cspecs = self.model.cache_specs(self.slots, max_len)
        self.params = place(self.params, shardings(pspecs, self.mesh, rules))
        self.cache = place(self.cache, shardings(cspecs, self.mesh, rules))
        check_placed_bytes(self.params)
        check_placed_bytes(self.cache)
        self.replicated_leaves = fallback_leaves(pspecs, self.mesh, rules) \
            + fallback_leaves({"layers": cspecs["layers"]}, self.mesh, rules,
                              "cache")

    # -- stepping ------------------------------------------------------------

    def _raw_step(self):
        """``(logits, new_cache)`` of one step; a PCILT step with the
        sentinel leaves its device counters in ``self._last_sat``."""
        toks = torch.from_numpy(self.tokens).to(self.device)
        if self.pdecode is None:  # masks the padded vocabulary itself
            return self.decode(self.params, self.cache, toks)
        lmask, hmask = self.monitor.ok_masks()
        if self.sentinel:
            logits, new_cache, self._last_sat = self.pdecode.step(
                self.params, self.cache, toks, lmask, hmask,
                with_stats=True)
        else:
            logits, new_cache = self.pdecode.step(
                self.params, self.cache, toks, lmask, hmask)
        if self.cfg.padded_vocab > self.cfg.vocab:  # never sample padding
            logits[..., self.cfg.vocab:] = -1e30
        return logits, new_cache

    def _step(self) -> np.ndarray:
        # chaos clock: every due injection fires once, before the forward
        for k in sorted(k for k in self.chaos if k <= self.steps):
            for act in self.chaos.pop(k):
                act(self)
        self.steps += 1
        if self.step_cost_s is not None:
            self.clock.sleep(self.step_cost_s)  # simulated service time
        t0 = time.perf_counter()
        with torch.no_grad():
            self._last_sat = None
            logits, new_cache = self._raw_step()
            # finite gate before the commit: logits and every floating
            # state tensor (quantization launders NaN into a valid lookup,
            # so poisoned state can yield finite logits)
            checks = [torch.isfinite(logits).all()]
            checks += [torch.isfinite(t).all().to(logits.device)
                       for t in _float_blocks(new_cache)]
            parts = [logits.argmax(-1), torch.stack(checks).all().long()[None]]
            sat = self._last_sat
            if sat is not None:  # the counters ride the same transfer
                for g in HealthMonitor.SAT_GRIDS:
                    parts += [sat[g]["count"].long(),
                              sat[g]["ratio"].float().view(torch.int32).long()]
            host = torch.cat(parts).cpu().numpy()
        self.step_seconds.append(time.perf_counter() - t0)
        B, L = self.slots, self.cfg.n_layers
        if sat is not None:
            self._last_sat = {}
            for i, g in enumerate(HealthMonitor.SAT_GRIDS):
                at = B + 1 + 2 * L * i
                self._last_sat[g] = {
                    "count": host[at:at + L],
                    "ratio": host[at + L:at + 2 * L].astype(np.int32)
                    .view(np.float32)}
        if not host[B]:
            raise RuntimeError("non-finite decode outputs or state (NaN/Inf)")
        self.cache = new_cache
        return host[:B]

    def _prefill_into_slot(self, slot: int, req: Request):
        """Feed the prompt through decode steps (teacher-forced prefill);
        concurrently active slots commit the tokens they generate meanwhile,
        and the step that consumes the last prompt token emits the
        request's first token."""
        req.outcome = "active"
        req.t_admit = self.clock.time()
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
        # tainted: a layer was recalibrated online; its tokens are right
        # under the new tables but not comparable to the conversion's, so
        # they are marked degraded too
        degraded_now = self.monitor is not None and (
            self.monitor.degraded or self.monitor.tainted)
        for s, req in enumerate(self.active):
            if req is None or s == skip:
                continue
            tok = int(nxt[s])
            req.out.append(tok)
            self.tokens[s, 0] = tok
            if degraded_now:
                req.degraded = True
            self._finish_if_done(s)

    def _finish_if_done(self, s: int):
        req = self.active[s]
        if req is not None and len(req.out) >= req.max_new:
            req.done = True
            req.outcome = "degraded" if req.degraded else "served"
            req.t_done = self.clock.time()
            self.active[s] = None
            self._reset_slot(s)

    def _reset_slot(self, s: int):
        """Zero one slot's rows of every per-layer state (axis 1, in place)
        so a recycled or evicted slot never leaks a previous request's
        context."""
        for t in tree_leaves(self.cache["layers"]):
            if t.dim() >= 2 and t.shape[1] == self.slots:
                if isinstance(t, Placed):
                    t.fill_index_(1, s, 0)
                else:
                    t[:, s] = 0

    # -- checkpoint ring -----------------------------------------------------

    def _checkpoint(self):
        """Snapshot the engine state: a clone of the cache (the live one
        changes in place) and copies of the host state."""
        self.ckpts.append({
            "tick": self.tick,
            "cache": tree_map(_clone, self.cache),
            "tokens": self.tokens.copy(),
            "active": list(self.active),
            "queue": list(self.queue),
            "pending": list(self._pending),
            "queue_evictions": self.queue_evictions,
            "slot_evictions": self.slot_evictions,
            "reqs": {r.rid: (list(r.out), r.done, r.outcome, r.retries,
                             r.degraded, r.t_admit, r.not_before,
                             r.t_arrive, r.t_enqueue, r.t_done)
                     for r in self._requests},
        })

    def _restore(self, target_tick: int):
        """Restore the newest checkpoint at or before ``target_tick`` (else
        the oldest retained), handing out a clone of its cache."""
        snaps = [c for c in self.ckpts if c["tick"] <= target_tick]
        snap = snaps[-1] if snaps else self.ckpts[0]
        # drop the snapshots of ticks the replay will redo
        keep = [c for c in self.ckpts if c["tick"] <= snap["tick"]
                and c is not snap] + [snap]
        self.ckpts = deque(keep, maxlen=self.ckpts.maxlen)
        self.cache = tree_map(_clone, snap["cache"])
        self.tokens = snap["tokens"].copy()
        self.active = list(snap["active"])
        self.queue = list(snap["queue"])
        self._pending = list(snap["pending"])
        self.queue_evictions = snap["queue_evictions"]
        self.slot_evictions = snap["slot_evictions"]
        for r in self._requests:
            (out, done, outcome, retries, degraded, t_admit, nb,
             t_arrive, t_enqueue, t_done) = snap["reqs"][r.rid]
            r.out, r.done, r.outcome = list(out), done, outcome
            r.retries, r.degraded, r.t_admit, r.not_before = \
                retries, degraded, t_admit, nb
            r.t_arrive, r.t_enqueue, r.t_done = t_arrive, t_enqueue, t_done
        self.tick = snap["tick"]
        self.telemetry = [e for e in self.telemetry if e["tick"] < self.tick]
        if self.monitor is not None:
            # a verification at a rewound tick vouches for no committed
            # token: clamp, so a later breach rolls back far enough
            np.minimum(self.monitor.last_verified, self.tick,
                       out=self.monitor.last_verified)
            self.monitor.head_last_verified = min(
                self.monitor.head_last_verified, self.tick)
        log.warning("restored engine state at tick %d", self.tick)

    # -- admission / scheduling ----------------------------------------------

    def _est_ticks(self, req: Request) -> int:
        """Steps one attempt of ``req`` costs: the prompt replayed, then
        one step a generated token."""
        return len(req.prompt) + req.max_new

    def _est_turnaround_s(self, req: Request) -> Optional[float]:
        """The backlog ahead of ``req`` over the slots plus its own attempt,
        at the observed tick EMA (None until a tick was measured)."""
        if self._tick_ema is None:
            return None
        backlog = sum(self._est_ticks(r) for r in self.queue)
        backlog += sum(max(0, r.max_new - len(r.out))
                       for r in self.active if r is not None)
        return (backlog / self.slots + self._est_ticks(req)) * self._tick_ema

    def _submit(self, req: Request, now: float) -> bool:
        """Admission: enqueue, or shed with the typed ``rejected`` outcome
        when the bounded queue is full or the deadline is already
        unmeetable."""
        req.t_arrive = req.t_enqueue = now
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            req.done = True
            req.outcome = "rejected"
            req.t_done = now
            log.warning("req %d rejected: queue full (%d >= %d)",
                        req.rid, len(self.queue), self.queue_limit)
            return False
        if req.deadline_s is not None:
            est = self._est_turnaround_s(req)
            if est is not None and est > req.deadline_s:
                req.done = True
                req.outcome = "rejected"
                req.t_done = now
                log.warning("req %d rejected: estimated turnaround %.3fs > "
                            "deadline %.3fs", req.rid, est, req.deadline_s)
                return False
        req.outcome = "queued"
        self.queue.append(req)
        return True

    def _admit_arrivals(self, now: float):
        due = [p for p in self._pending if p[0] <= now]
        if due:
            self._pending = [p for p in self._pending if p[0] > now]
            for _, req in due:
                self._submit(req, now)

    def _edf_pick(self, now: float) -> Optional[int]:
        """Earliest deadline first among the queued requests not backing
        off; no-deadline requests last, FIFO ties."""
        best = None
        best_key = None
        for i, r in enumerate(self.queue):
            if r.not_before > now:
                continue
            d = (r.t_enqueue + r.deadline_s if r.deadline_s is not None
                 else math.inf)
            key = (d, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    # -- deadlines -----------------------------------------------------------

    def _enforce_deadlines(self):
        now = self.clock.time()
        for s, req in enumerate(self.active):
            if req is None or req.deadline_s is None:
                continue
            if now - req.t_admit <= req.deadline_s:
                continue
            self.active[s] = None
            self._reset_slot(s)
            self.slot_evictions += 1
            req.out = []
            req.degraded = False
            req.retries += 1
            if req.retries > req.max_retries:
                req.done = True
                req.outcome = "failed"
                req.t_done = now
                log.error("req %d failed: deadline %.3fs exceeded %d times",
                          req.rid, req.deadline_s, req.retries)
            else:
                req.not_before = now + 0.05 * (2 ** (req.retries - 1))
                req.outcome = "queued"
                # the new attempt's window opens when the backoff expires
                req.t_enqueue = req.not_before
                self.queue.append(req)
                log.warning("req %d missed deadline; requeued (retry %d/%d, "
                            "backoff %.3fs)", req.rid, req.retries,
                            req.max_retries, req.not_before - now)
        # a request past its attempt deadline while still queued is evicted
        # here, before it burns prefill steps
        still: List[Request] = []
        for req in self.queue:
            if req.deadline_s is None or now - req.t_enqueue <= req.deadline_s:
                still.append(req)
                continue
            self.queue_evictions += 1
            req.retries += 1
            if req.retries > req.max_retries:
                req.done = True
                req.outcome = "failed"
                req.t_done = now
                log.error("req %d failed: deadline %.3fs expired in queue "
                          "(%d attempts)", req.rid, req.deadline_s,
                          req.retries)
            else:
                req.not_before = now + 0.05 * (2 ** (req.retries - 1))
                req.t_enqueue = req.not_before
                still.append(req)
                log.warning("req %d deadline expired while queued; attempt "
                            "window reset (retry %d/%d)", req.rid,
                            req.retries, req.max_retries)
        self.queue = still

    # -- main loop -----------------------------------------------------------

    def run(self, requests: List[Request]) -> Dict:
        """Closed-loop serving: every request offered at once."""
        now = self.clock.time()
        return self._serve([(now, r) for r in requests])

    def run_traffic(self, requests: List[Request],
                    arrivals: Sequence[float]) -> Dict:
        """Open-loop serving: ``requests[i]`` reaches the engine at clock
        time ``arrivals[i]``."""
        if len(requests) != len(arrivals):
            raise ValueError(
                f"{len(requests)} requests but {len(arrivals)} arrival "
                f"times — the traffic trace must cover every request")
        pending = sorted(zip((float(t) for t in arrivals), requests),
                         key=lambda p: p[0])
        return self._serve(pending)

    def _serve(self, pending: List[Tuple[float, Request]]) -> Dict:
        self._requests = [r for _, r in pending]
        self._pending = list(pending)
        self.queue = []
        for r in self._requests:
            r.outcome = "queued"
        t0 = self.clock.time()
        self.tick = 0
        self.prefill_ticks = 0
        self.queue_evictions = 0
        self.slot_evictions = 0
        self.telemetry = []
        self._tick_ema = None
        self.ckpts.clear()
        self._checkpoint()
        watchdog = StepWatchdog()
        while (self._pending or self.queue
               or any(r is not None for r in self.active)):
            try:
                t_tick = self.clock.time()
                now = t_tick
                self._admit_arrivals(now)
                for s in range(self.slots):
                    if self.active[s] is not None or not self.queue:
                        continue
                    i = self._edf_pick(now)
                    if i is None:
                        break  # every queued request is backing off
                    self._prefill_into_slot(s, self.queue.pop(i))
                if not any(r is not None for r in self.active):
                    if self.queue:
                        self.clock.sleep(0.005)  # wait out the backoff
                        self._enforce_deadlines()
                    elif self._pending:
                        nxt = min(t for t, _ in self._pending)
                        self.clock.sleep(max(nxt - now, 1e-9))
                    continue
                nxt = self._step()
                if self.monitor is not None:
                    breaches = self.monitor.on_tick(
                        self.tick, sat=self._last_sat, rows=self.slots)
                    if breaches:
                        # a table breach indicts the commits since the layer
                        # was last verified; drift only this tick's
                        lv = [int(self.monitor.last_verified[e["layer"]])
                              for e in breaches
                              if e["layer"] is not None
                              and e["kind"] != "drift"]
                        lv += [int(self.monitor.head_last_verified)
                               for e in breaches if e["kind"] == "head"]
                        lv += [self.tick for e in breaches
                               if e["kind"] == "drift"]
                        raise _Degraded(max(min(lv), 0), breaches)
                self._commit_tokens(nxt)
                self._enforce_deadlines()
                dt = self.clock.time() - t_tick
                watchdog.observe(self.tick, dt)
                self._tick_ema = (dt if self._tick_ema is None
                                  else 0.9 * self._tick_ema + 0.1 * dt)
                occupied = sum(r is not None for r in self.active)
                entry = {
                    "tick": self.tick,
                    "t": self.clock.time(),
                    "queue_depth": len(self.queue),
                    "pending": len(self._pending),
                    "active_slots": occupied,
                    "occupancy": occupied / self.slots,
                    "queue_evictions": self.queue_evictions,
                    "slot_evictions": self.slot_evictions,
                    "tick_s": dt,
                }
                if self.sentinel and self.monitor is not None:
                    entry["saturation"] = self.monitor.saturation_summary()
                self.telemetry.append(entry)
                self.tick += 1
                self._checkpoint()
            except _Degraded as d:
                self.rollbacks += 1
                log.warning("rolling back to tick <= %d after %d breach(es)",
                            d.target_tick, len(d.events))
                self._restore(d.target_tick)
                if self.monitor is not None and self.monitor.drift_pending:
                    # online recalibration between ticks, then replay
                    self.monitor.recalibrate_pending(self.tick)
            except Exception as e:  # noqa: BLE001 — any tick fault
                self.restarts += 1
                log.error("decode tick %d failed (%s); restart %d/%d",
                          self.tick, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                self._restore(self.tick)
        dt = self.clock.time() - t0
        # outcomes from the final request state: replays never double-count
        outcomes = {r.rid: r.outcome for r in self._requests}
        offered = len(self._requests)
        rejected = sum(o == "rejected" for o in outcomes.values())
        stats = {
            "decode_ticks": self.tick,
            "prefill_ticks": self.prefill_ticks,
            "wall_s": dt,
            "offered": offered,
            "served": sum(o == "served" for o in outcomes.values()),
            "degraded": sum(o == "degraded" for o in outcomes.values()),
            "failed": sum(o == "failed" for o in outcomes.values()),
            "rejected": rejected,
            "shed_rate": rejected / offered if offered else 0.0,
            "retried": sum(r.retries > 0 for r in self._requests),
            "restarts": self.restarts,
            "rollbacks": self.rollbacks,
            "queue_evictions": self.queue_evictions,
            "slot_evictions": self.slot_evictions,
            "straggler_ticks": list(watchdog.flagged),
            "outcomes": outcomes,
            "telemetry": list(self.telemetry),
            "table_bytes": (self.pdecode.table_bytes()
                            if self.pdecode is not None else 0),
        }
        if self.monitor is not None:
            stats["health_events"] = list(self.monitor.events)
            if self.sentinel:
                stats["saturation"] = self.monitor.saturation_summary()
                stats["recalibrations"] = int(
                    self.monitor.recalibrations.sum())
        return stats


def token_latencies(requests: Sequence[Request]) -> List[float]:
    """Seconds per token, arrival to completion, of every completed
    request."""
    out = []
    for r in requests:
        if r.outcome in ("served", "degraded") and r.out:
            out.append((r.t_done - r.t_arrive) / len(r.out))
    return out


def verify_accounting(requests: Sequence[Request], stats: Dict) -> None:
    """Every request ends in exactly one typed outcome and the counts
    partition the offered set; raises ``SystemExit`` otherwise."""
    bad = [r.rid for r in requests if r.outcome not in OUTCOMES]
    if bad:
        raise SystemExit(
            f"accounting violated: requests {bad} ended without a terminal "
            f"outcome (allowed: {OUTCOMES})")
    total = sum(stats[k] for k in OUTCOMES)
    if total != stats["offered"] or stats["offered"] != len(requests):
        raise SystemExit(
            f"accounting violated: served+degraded+failed+rejected = {total} "
            f"!= offered = {stats['offered']} (requests: {len(requests)})")
    undone = [r.rid for r in requests if not r.done]
    if undone:
        raise SystemExit(
            f"accounting violated: requests {undone} have a terminal outcome "
            f"but done=False")


def _chaos_plan(eng: Engine, injector):
    """The ``--chaos`` fault schedule: one action per fault class."""
    from repro_torch.kernels import autotune as atn

    def garble_autotune(e):
        cache = atn.get_cache()
        # bytes to garble, then corrupt them in place: the reload must warn
        # and quarantine, never crash or silently reset
        cache.record("chaos_probe|B=1,dtype=float32|backend=cpu", "direct",
                     None, 0)
        injector.garble_file(cache.path, "garbage")
        atn.reset_cache(cache.path)

    def poison_state(e):
        layers = e.cache["layers"]
        e.cache = dict(e.cache, layers=dict(
            layers, ssd=injector.poison(layers["ssd"], "nan", n=4)))

    def corrupt_proj(e):
        tabs = e.pdecode.pcilt["proj"]["tables"]
        tabs["wx"] = injector.corrupt_table(tabs["wx"], n_flips=2)  # in place
        e.pdecode.rehoist()

    def flip_head(e):
        head = e.pdecode.pcilt["head"]
        head["seg_idx"] = injector.flip_seg_idx(
            head["seg_idx"], n_pool=head["pool"].shape[0])
        e.pdecode.rehoist()

    # keyed on the monotone step counter (prefill + decode steps)
    return {
        4: [garble_autotune],
        7: [lambda e: injector.maybe_fail(7)],
        11: [poison_state],
        15: [corrupt_proj],
        19: [flip_head],
    }


#: the drift smoke's injection: one layer's mixer norm gain, amplified so
#: that the first monitored tick classifies it "saturated"
DRIFT_LAYER = 1
DRIFT_GAMMA = 64.0
DRIFT_STEP = 10


def _chaos_drift_plan(eng: Engine, injector):
    """The ``--chaos-drift`` schedule: amplify one layer's mixer norm gain
    so its ``wo`` activations leave the calibrated range.  No table byte
    changes; only the saturation counters can catch it."""

    def drift_norm(e):
        blocks = dict(e.params["blocks"])
        mixer = dict(blocks["mixer"])
        norm = dict(mixer["norm"])
        norm["scale"] = injector.drift_scale(norm["scale"], DRIFT_GAMMA,
                                             rows=[DRIFT_LAYER])
        mixer["norm"] = norm
        blocks["mixer"] = mixer
        # outside the checkpoint ring: a rollback must not undo the drift
        e.params = dict(e.params, blocks=blocks)

    return {DRIFT_STEP: [drift_norm]}


def make_requests(cfg, n: int, max_new: int, seed: int,
                  deadline: Optional[float] = None) -> List[Request]:
    """Seeded prompts of 4..11 tokens (the reference engine's stream)."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(2, cfg.vocab, size=rng.integers(4, 12)),
                    max_new, deadline_s=deadline) for i in range(n)]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--full", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--pcilt", action="store_true",
                   help="serve the converted PCILT decode path under the "
                        "health monitor")
    p.add_argument("--chaos", action="store_true",
                   help="drive the fault-injection schedule and verify the "
                        "resilience contract (implies a reference run)")
    p.add_argument("--chaos-drift", action="store_true",
                   help="inject calibration drift (no corrupted bytes) and "
                        "verify the sentinel contract: detect -> demote -> "
                        "recalibrate -> repromote (requires --pcilt)")
    p.add_argument("--no-sentinel", action="store_true",
                   help="serve unmonitored (no in-kernel saturation "
                        "counters)")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request deadline in seconds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--traffic", choices=("poisson", "burst", "ramp"),
                   default=None,
                   help="open-loop arrival profile on a virtual clock; "
                        "verifies the outcome-accounting invariant")
    p.add_argument("--load", type=float, default=1.0,
                   help="offered load as a multiple of analytic capacity "
                        "(--traffic only; 2.0 = overload)")
    p.add_argument("--rate", type=float, default=None,
                   help="explicit arrival rate in requests/s (overrides "
                        "--load)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bounded admission queue depth (default: 2*slots "
                        "under --traffic, unbounded otherwise)")
    p.add_argument("--step-cost", type=float, default=1e-3,
                   help="simulated seconds per engine step on the virtual "
                        "clock (--traffic only)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.chaos_drift and args.chaos:
        raise SystemExit("--chaos-drift and --chaos are separate smokes — "
                         "run them as two invocations")
    if args.chaos_drift and not args.pcilt:
        raise SystemExit("--chaos-drift exercises the PCILT drift sentinel; "
                         "add --pcilt")
    if args.chaos_drift and args.no_sentinel:
        raise SystemExit("--chaos-drift needs the sentinel; drop "
                         "--no-sentinel")
    return args


def _engine(cfg, args, **kw) -> Engine:
    return Engine(cfg, slots=args.slots, pcilt=args.pcilt, seed=args.seed,
                  device=args.device, **kw)


def run_cli(cfg, args) -> Dict:
    """Serve ``args``' request stream on ``cfg`` (with ``cfg.pcilt`` set for
    ``--pcilt``), print the outcome and verify the contract the flags ask
    for (``SystemExit`` on a violation); returns the stats."""
    reqs = make_requests(cfg, args.requests, args.max_new, args.seed,
                         args.deadline)
    engine_kw = {}
    arrivals = None
    if args.traffic:
        from repro_torch.runtime import VirtualClock, make_arrivals

        engine_kw = dict(clock=VirtualClock(), step_cost_s=args.step_cost,
                         queue_limit=args.queue_limit
                         if args.queue_limit is not None else 2 * args.slots)
        # analytic capacity on the virtual clock: prefill steps serialize,
        # decode steps are shared by the active slots
        steps_per_req = 7.5 + args.max_new / args.slots  # prompts are 4..11
        capacity = 1.0 / (steps_per_req * args.step_cost)
        rate = args.rate if args.rate is not None else args.load * capacity
        arrivals = make_arrivals(args.traffic, args.requests, rate,
                                 seed=args.seed)
        print(f"traffic: {args.traffic} arrivals at {rate:.1f} req/s "
              f"({args.load:.2f}x capacity {capacity:.1f} req/s), "
              f"queue_limit={engine_kw['queue_limit']}")
    elif args.queue_limit is not None:
        engine_kw = dict(queue_limit=args.queue_limit)

    from repro_torch.runtime import FaultInjector

    injector = None
    eng = _engine(cfg, args, sentinel=not args.no_sentinel, **engine_kw)
    if args.chaos:
        injector = FaultInjector(fail_at=(7,), seed=args.seed)
        if eng.pdecode is not None:
            if "REPRO_PCILT_TUNE_CACHE" not in os.environ:
                # the plan garbles the design cache's file: a fresh one,
                # never the user's
                from repro_torch.kernels import autotune as atn

                atn.reset_cache(os.path.join(tempfile.mkdtemp(),
                                             "tiles.json"))
            eng.chaos = _chaos_plan(eng, injector)
        else:
            eng.chaos = {4: [lambda e: injector.maybe_fail(7)]}
    elif args.chaos_drift:
        injector = FaultInjector(seed=args.seed)
        eng.chaos = _chaos_drift_plan(eng, injector)

    if arrivals is not None:
        stats = eng.run_traffic(reqs, arrivals)
    else:
        stats = eng.run(reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> {r.out[:8]}... "
              f"[{r.outcome}]")
    n_completed = sum(r.outcome in ("served", "degraded") for r in reqs)
    print(f"served {n_completed} requests in {stats['wall_s']:.2f}s "
          f"({stats['decode_ticks']} decode ticks)")
    if stats["degraded"] or stats["restarts"] or stats["rollbacks"]:
        print(f"resilience: degraded={stats['degraded']} "
              f"retried={stats['retried']} failed={stats['failed']} "
              f"restarts={stats['restarts']} rollbacks={stats['rollbacks']}")

    if arrivals is not None:
        verify_accounting(reqs, stats)
        lats = token_latencies(reqs)
        p50 = float(np.percentile(lats, 50)) if lats else float("nan")
        p99 = float(np.percentile(lats, 99)) if lats else float("nan")
        print(f"overload: rejected={stats['rejected']} "
              f"(shed {100 * stats['shed_rate']:.1f}%) "
              f"queue_evictions={stats['queue_evictions']} "
              f"slot_evictions={stats['slot_evictions']} "
              f"p50/p99 token latency {p50:.4f}/{p99:.4f}s")
        print("accounting invariant verified: "
              f"{stats['served']}+{stats['degraded']}+{stats['failed']}"
              f"+{stats['rejected']} == {stats['offered']} offered")

    if args.chaos:
        if arrivals is not None:
            _verify_chaos_traffic_contract(cfg, args, eng, reqs, stats,
                                           injector, arrivals, engine_kw)
        else:
            _verify_chaos_contract(cfg, args, eng, reqs, stats, injector)
    elif args.chaos_drift:
        _verify_chaos_drift_contract(cfg, args, eng, reqs, stats, injector)
    return stats


def main(argv=None):
    import dataclasses

    from repro_torch.configs.base import PCILTConfig

    args = parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    resolve_device(args.device)  # CUDA unless asked for the CPU
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.n_img_tokens or cfg.encoder_layers:
        raise SystemExit("serve demo targets text decoder archs")
    if args.pcilt:
        if cfg.ssm is None:
            raise SystemExit("--pcilt serves the converted Mamba decode "
                             "path; pick an [ssm] arch (e.g. mamba2-130m)")
        cfg = dataclasses.replace(cfg, pcilt=PCILTConfig(act_bits=4, group=2),
                                  dtype=torch.float32)
    run_cli(cfg, args)


def _verify_chaos_contract(cfg, args, eng, reqs, stats, injector):
    """No request lost, undegraded tokens identical to a fault-free run,
    and the demoted step equal to the dense fake-quant oracle; exits
    non-zero on any violation."""
    lost = [r.rid for r in reqs if r.outcome not in ("served", "degraded")]
    if lost:
        raise SystemExit(f"chaos contract violated: requests lost: {lost}")
    if not injector.events:
        raise SystemExit("chaos smoke injected no faults — schedule never "
                         "fired (engine finished too fast?)")
    if eng.chaos:
        raise SystemExit(f"chaos smoke left faults unfired at step keys "
                         f"{sorted(eng.chaos)} (engine ran only "
                         f"{eng.steps} steps)")

    # fault-free reference run: the same parameters and request stream
    ref_eng = _engine(cfg, args)
    ref = make_requests(cfg, args.requests, args.max_new, args.seed,
                        args.deadline)
    ref_eng.run(ref)
    del ref_eng
    mismatched = [r.rid for r, q in zip(reqs, ref)
                  if r.outcome == "served" and r.out != q.out]
    if mismatched:
        raise SystemExit(
            f"chaos contract violated: undegraded tokens diverge from the "
            f"fault-free run for requests {mismatched}")
    n_exact = sum(r.outcome == "served" for r in reqs)

    if eng.pdecode is not None:
        # demoted decode == dense fake-quant oracle (one explicit step)
        pc_fq = dict(eng.pdecode.pcilt)
        proj = pc_fq.get("proj")
        B = args.slots
        cache = materialize(eng.model.cache_specs(B), 5, device=eng.device)
        tok = torch.full((B, 1), 3, dtype=torch.int64, device=eng.device)
        with torch.no_grad():
            got, _ = eng.pdecode.step(eng.params, cache, tok,
                                      layer_ok=[False] * cfg.n_layers,
                                      head_ok=False)
            if proj is not None:
                pc_fq["proj"] = dict(proj, path="dense_fq")
            want, _ = eng.model.decode_step(eng.params, cache, tok,
                                            pcilt=pc_fq, head_ok=False)
        if not torch.allclose(got.float(), want.float(), rtol=1e-4,
                              atol=1e-4):
            raise SystemExit("chaos contract violated: demoted decode "
                             "diverges from the dense fake-quant oracle")
    print(f"chaos contract verified: {len(reqs)} requests completed "
          f"({n_exact} token-identical to fault-free run, "
          f"{len(injector.events)} faults injected, "
          f"{stats['restarts']} restarts, {stats['rollbacks']} rollbacks, "
          f"{stats['degraded']} degraded)")


def _verify_chaos_drift_contract(cfg, args, eng, reqs, stats, injector):
    """Injected drift caught by the saturation counters, the drifted layer
    demoted, recalibrated and repromoted, no request lost, the rewritten
    tables bit-equal to a fresh build at the recorded scale, undegraded
    tokens identical to a fault-free run; exits non-zero on any
    violation."""
    from repro_torch.core.pcilt import build_grouped_tables, build_paired_tables

    lost = [r.rid for r in reqs if r.outcome not in ("served", "degraded")]
    if lost:
        raise SystemExit(f"drift contract violated: requests lost: {lost}")
    drifts = [e for e in injector.events if e["kind"] == "calibration_drift"]
    if not drifts:
        raise SystemExit("drift smoke never injected — schedule never fired "
                         f"(engine ran only {eng.steps} steps)")
    events = stats["health_events"]
    demotions = [e for e in events if e["kind"] == "drift"]
    recals = [e for e in events if e["kind"] == "recalibrate"]
    if not demotions:
        raise SystemExit("drift contract violated: sentinel never fired "
                         f"(saturation: {stats.get('saturation')})")
    if any(e["layer"] != DRIFT_LAYER for e in demotions):
        raise SystemExit(f"drift contract violated: demotions fired off the "
                         f"drifted layer {DRIFT_LAYER}: {demotions}")
    if not recals:
        raise SystemExit("drift contract violated: no online recalibration "
                         f"(events: {[e['kind'] for e in events]})")
    mon = eng.monitor
    bad = [l for l in range(mon.n_layers) if not mon.layer_ok[l]]
    if bad:
        raise SystemExit(f"drift contract violated: layers {bad} not "
                         "repromoted after recalibration")

    # the rewritten tables == a fresh conversion-arithmetic build at the
    # recorded scale, bitwise
    proj = eng.pdecode.pcilt["proj"]
    spec, group = proj["spec"], proj["group"]
    paired = bool(proj.get("paired"))
    with torch.no_grad():
        for ev in recals:
            l = ev["layer"]
            for name, new_scale in ev["scales"].items():
                if float(proj["scales"][name][l]) != new_scale:
                    continue  # a later recalibration superseded this one
                wf = eng.params["blocks"]["mixer"][name]["kernel"][l].float()
                t = proj["tables"][name]
                if paired:
                    ref = build_paired_tables(wf, spec, new_scale, group)
                    got = t[:, l]
                else:
                    pad = (-wf.shape[0]) % group
                    if pad:
                        wf = torch.cat([wf, wf.new_zeros((pad, wf.shape[1]))],
                                       0)
                    ref = build_grouped_tables(wf, spec, new_scale, group)
                    got = t[l]
                if not torch.equal(got, ref.to(got.dtype)):
                    raise SystemExit(
                        f"drift contract violated: recalibrated table "
                        f"{name}[{l}] != fresh build at scale {new_scale}")

    ref_eng = _engine(cfg, args)
    ref = make_requests(cfg, args.requests, args.max_new, args.seed,
                        args.deadline)
    ref_eng.run(ref)
    del ref_eng
    mismatched = [r.rid for r, q in zip(reqs, ref)
                  if r.outcome == "served" and r.out != q.out]
    if mismatched:
        raise SystemExit(
            f"drift contract violated: undrifted tokens diverge from the "
            f"fault-free run for requests {mismatched}")
    print(f"drift contract verified: {len(reqs)} requests completed, "
          f"sentinel fired {len(demotions)}x on layer {DRIFT_LAYER}, "
          f"{len(recals)} recalibration(s), {stats['rollbacks']} "
          f"rollback(s), {stats['degraded']} degraded; recalibrated tables "
          f"bit-equal to fresh build at the new scale")


def _verify_chaos_traffic_contract(cfg, args, eng, reqs, stats, injector,
                                   arrivals, engine_kw):
    """Chaos under traffic: every outcome typed and accounted, and every
    request served undegraded in both the chaos run and a fault-free run
    of the same arrival trace token-identical."""
    from repro_torch.runtime import VirtualClock

    verify_accounting(reqs, stats)
    if not injector.events:
        raise SystemExit("chaos-under-traffic smoke injected no faults — "
                         "schedule never fired")
    ref_eng = _engine(cfg, args, **dict(engine_kw, clock=VirtualClock()))
    ref = make_requests(cfg, args.requests, args.max_new, args.seed,
                        args.deadline)
    ref_stats = ref_eng.run_traffic(ref, arrivals)
    del ref_eng
    verify_accounting(ref, ref_stats)
    mismatched = [r.rid for r, q in zip(reqs, ref)
                  if r.outcome == "served" and q.outcome == "served"
                  and r.out != q.out]
    if mismatched:
        raise SystemExit(
            f"chaos-under-traffic contract violated: undegraded tokens "
            f"diverge from the fault-free run for requests {mismatched}")
    print(f"chaos-under-traffic contract verified: {stats['offered']} "
          f"offered -> {stats['served']} served / {stats['degraded']} "
          f"degraded / {stats['failed']} failed / {stats['rejected']} "
          f"rejected; {len(injector.events)} faults injected, "
          f"{stats['restarts']} restarts, {stats['rollbacks']} rollbacks")


if __name__ == "__main__":
    main()
