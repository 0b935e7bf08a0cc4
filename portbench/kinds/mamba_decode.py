"""How the full-PCILT Mamba2 decode configurations run:
``repro_torch.launch.serve.Engine(cfg, slots=, pcilt=True, params=,
pcilt_bundle=)`` served with ``Engine.run`` under its ``HealthMonitor`` and
its default checkpoint ring.

Set-up: the parameters and the calibration tokens from the seed on the
card, ``convert_mamba_decode(..., head="shared")`` (its phases' seconds are
``convert_s``), the engine, and one warm run of short requests long enough
to pass every per-tick path of the monitor (its layer CRC, its dense-oracle
probe over all six projections, its head check).  The window hands the
engine the traffic's queue of requests at once; the slots take them as
they free (a closed loop whose queue never empties).  The engine's clock
closes the window: past ``--seconds`` its next reading ends the run.  The
tokens served in the window are every prompt token taken in (the engine
prefills by replaying the prompt through the decode step) and every token
generated.

Afterwards the tables are freed.  The reference recomputes the scales
from the same calibration tokens and runs once over a sample of the
finished requests, drawn from the seed with the longest among them: each
prompt with its served tokens.  The number compared is the widest gap by
which a served token's reference logit lies below the reference's best.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from .. import trace as tr
from .. import traffic as traffic_gen
from .. import weights, work
from ..manifest import module
from ..reference.quant import tf32

#: decode steps profiled in a traced run, and the window steps at which a
#: stretch of them starts (each later one only when the earlier ones lost
#: records)
PROFILED_STEPS = 16
PROFILE_AT = (24, 72, 120)


class WindowClosed(BaseException):
    """Raised by the engine's clock once the window is over; it passes the
    engine's own fault handling (``except Exception``) and ends ``run``."""

    def __init__(self, t: float):
        super().__init__(f"window closed at {t}")
        self.t = t


class WindowClock:
    """The engine's time source (``time()``, ``sleep(s)``): the host's
    monotonic clock, closing the window at ``deadline``."""

    def __init__(self):
        self.deadline = None

    def time(self) -> float:
        t = time.perf_counter()
        if self.deadline is not None and t >= self.deadline:
            raise WindowClosed(t)
        return t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


def model_config(cfg: Dict):
    import torch
    from repro_torch.configs.base import ModelConfig, PCILTConfig, SSMConfig

    mc = ModelConfig(
        name=cfg["name"], family="ssm", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=cfg["vocab"], head_dim=1,
        ssm=SSMConfig(d_state=cfg["d_state"], head_dim=cfg["head_dim"],
                      n_groups=cfg["n_groups"],
                      conv_kernel=cfg["conv_kernel"], expand=cfg["expand"],
                      chunk=cfg["chunk"]),
        tie_embeddings=cfg["tie_embeddings"], norm_eps=cfg["norm_eps"],
        pcilt=PCILTConfig(act_bits=cfg["act_bits"], group=cfg["group"]),
        dtype=torch.float32)
    if not cfg["tie_embeddings"] or cfg["head"] != "shared":
        raise ValueError("this kind serves a tied, shared-pool head")
    return mc


class _Instruments:
    """The traced run's spans around calls into the port: each decode
    step between marker kernels (``trace`` segments ``step`` and ``tick``)
    for ``PROFILED_STEPS`` steps from ``PROFILE_AT`` on, and the monitor's
    tick on the host clock."""

    def __init__(self, torch, eng, ops):
        self.torch, self.eng, self.ops = torch, eng, ops
        self.monitor_s: List[float] = []
        self.profiled: set = set()
        self.step_at = 0
        self.stretch = None
        self.stretches = []
        self.launches0 = 0
        self._step, self._tick = eng._step, eng.monitor.on_tick
        eng._step, eng.monitor.on_tick = self.step, self.on_tick

    def step(self):
        i = self.step_at
        self.step_at += 1
        if i in PROFILE_AT and not any(map(self.whole, self.stretches)):
            self.stretch = tr.Stretch(self.torch).__enter__()
            self.launches0 = sum(self.ops.LAUNCHES.values())
        if self.stretch is None:
            return self._step()
        self.profiled.add(len(self.eng.step_seconds))
        tr.marker(self.torch)
        out = self._step()
        tr.marker(self.torch)
        if i - PROFILED_STEPS + 1 in PROFILE_AT and self.stretch is not None:
            s, self.stretch = self.stretch, None
            s.__exit__(None, None, None)
            s.ops_launches = sum(self.ops.LAUNCHES.values()) - self.launches0
            self.stretches.append(s)
        return out

    def on_tick(self, *a, **kw):
        t0 = time.perf_counter()
        out = self._tick(*a, **kw)
        if self.stretch is None:
            self.monitor_s.append(time.perf_counter() - t0)
        return out

    @staticmethod
    def labels():
        return ["step", "tick"] * PROFILED_STEPS

    def whole(self, s) -> bool:
        """Every marker and every counted launch of the port's kernels is in
        the stretch's trace."""
        return tr.segments(s.events, self.labels()) is not None and \
            tr.launches(s.events, port_only=True) >= s.ops_launches

    def close(self):
        if self.stretch is not None:  # the window closed inside a stretch
            self.stretch.__exit__(None, None, None)
            self.stretch = None
        self.eng._step, self.eng.monitor.on_tick = self._step, self._tick

    def read(self, batch: int) -> Dict:
        good = [s for s in self.stretches if self.whole(s)]
        if not good:
            return None
        s = good[0]
        segs = tr.segments(s.events, self.labels())
        body = segs["step"] + segs["tick"]
        what = {"step": "a decode step: the host dispatching its launches",
                "tick": "between steps: commit, monitor, checkpoint, "
                        "admission"}
        return {"window_s": s.window_s, "busy_s": tr.busy_s(body),
                "units": PROFILED_STEPS, "batch": batch,
                "device_s": tr.device_s(body),
                "segments": {k: {"device_s": tr.device_s(v),
                                 "launches": tr.launches(v)}
                             for k, v in segs.items()},
                "port_launches": tr.launches(body, port_only=True),
                "ops_launches": s.ops_launches,
                "device_ops": tr.top_ops(body),
                "idle_gaps": tr.idle_gaps(s.events, self.labels(), what)}


def run(ctx: Dict) -> Dict:
    import torch
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models.mamba import MambaLM

    cfg, traffic, seed = ctx["cfg"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    ref = module("reference", cfg["reference"])
    traffic_gen.check(traffic)
    mc = model_config(cfg)
    if mc.padded_vocab != ref.padded_vocab(cfg):
        raise ValueError("the port pads the vocabulary otherwise")
    model = MambaLM(mc)
    params = weights.make(ref.layout(cfg), seed, device)
    if weights.shapes(model.param_specs()) != weights.shapes(params):
        raise RuntimeError("the port's parameters are not the reference's")
    calib = torch.randint(0, cfg["vocab"], tuple(cfg["calibration_tokens"]),
                          generator=weights.generator(seed, "calibration",
                                                      device), device=device)
    timings: Dict[str, float] = {}
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dec = convert_mamba_decode(model, params, calib, head="shared",
                               table_dtype=dtype[cfg["table_dtype"]],
                               timings=timings, device=device)
    clock = WindowClock()
    eng = Engine(mc, slots=cfg["slots"], pcilt=True, params=params,
                 pcilt_bundle=dec.pcilt, clock=clock, device=device)
    prog_scales = _scales(dec.pcilt)
    del dec
    # warm: every slot through prefill and decode, more ticks than layers
    # (the monitor checks one layer a tick, the head every n_layers ticks,
    # the dense oracle every fourth check over the six projections)
    warm = [Request(i, np.arange(2) + i, 6 * cfg["n_layers"] // 4 + 8)
            for i in range(cfg["slots"])]
    eng.run(warm)
    inst = None
    if ctx["trace"] and device != "cpu":
        tr.warm(torch)
        inst = _Instruments(torch, eng, ops)
    reqs = [Request(i, p, n) for i, (p, n) in enumerate(
        traffic_gen.prompts(traffic, seed, cfg["vocab"]))]
    n_steps0 = len(eng.step_seconds)
    t_start = time.perf_counter()
    clock.deadline = t_start + ctx["seconds"]
    drained = False
    try:
        eng.run(reqs)
        t_end = time.perf_counter()
        drained = True
    except WindowClosed as w:
        t_end = w.t
    if inst is not None:
        inst.close()
    clock.deadline = None
    tokens = eng.prefill_ticks + sum(len(r.out) for r in reqs)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    step_s = [s for i, s in enumerate(eng.step_seconds)
              if i >= n_steps0 and (inst is None or i not in inst.profiled)]
    events = list(eng.monitor.events)
    done = [r for r in reqs if r.outcome == "served"]
    attempted = [r for r in reqs if r.outcome != "queued"]
    failed = [r for r in attempted
              if r.outcome in ("failed", "rejected", "degraded")]
    rec = {"setup_s": t_start - ctx["t_process"],
           "window": {"seconds": t_end - t_start, "requests": len(done),
                      "tokens": tokens},
           "attempted": len(attempted), "failed": len(failed),
           "spans": {"convert_s": sum(timings.values()), "step_s": step_s},
           "work": {"step": work.mamba_step(cfg, cfg["slots"]),
                    "token_flops": work.mamba_token_flops(cfg)},
           "memory_peak_bytes": peak, "trace": None,
           "diag": [f"served {len(done)} requests, {tokens} tokens; "
                    f"health events {len(events)}; queue drained "
                    f"{drained}"]}
    if inst is not None:
        rec["spans"]["monitor_s"] = inst.monitor_s
        rec["trace"] = t = inst.read(cfg["slots"])
        if t:
            rec["diag"].append(
                f"traced {t['units']} steps: {t['port_launches']} launches "
                f"of the port's kernels, ops.LAUNCHES counted "
                f"{t['ops_launches']} calls")
    del eng, inst, reqs[:]
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    rec["checks"], rec["numbers"], rec["control"], diag = judge(
        torch, ref, cfg, params, calib, done, seed, ctx["limits"],
        ctx.get("control"), prog_scales)
    rec["diag"] += diag
    return rec


def _scales(pcilt: Dict) -> Dict:
    """The port's scales, for a diagnostic line only (never judged)."""
    proj = pcilt["proj"]["scales"]
    return {"in": proj["wx"].tolist(), "out": proj["wo"].tolist(),
            "conv": float(pcilt["scale"]),
            "head": float(pcilt["head"]["scale"])}


def sample(done: List, seed: int, served_tokens: int) -> List:
    """The longest finished request (prompt and output), then others drawn
    from the seed until ``served_tokens`` generated tokens are in."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-(len(r.prompt) + len(r.out)),
                                        r.rid))
    rng = np.random.default_rng(weights.derive(seed, "sample"))
    rest = [order[i + 1] for i in rng.permutation(len(order) - 1)]
    out, n = [], 0
    for r in [order[0]] + rest:
        if n >= served_tokens:
            break
        out.append(r)
        n += len(r.out)
    return out


def _gaps(torch, picked, logits, tokens, V):
    """Each served position's gap: how far the reference logit of the token
    at that position lies below the reference's best (``tokens`` per
    request, or None for the served ones)."""
    out = []
    for i, (r, lg) in enumerate(zip(picked, logits)):
        p = len(r.prompt)
        rows = lg[p - 1:p - 1 + len(r.out), :V]
        tok = torch.as_tensor(r.out, device=rows.device) if tokens is None \
            else tokens[i]
        out.append(rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)


def _numbers(gaps, margin: float) -> Dict[str, float]:
    return {"token_gap_mean": float(gaps.mean()),
            "token_gap_max": float(gaps.max()),
            "mismatch_share": float((gaps > margin).float().mean())}


def judge(torch, ref, cfg, params, calib, done, seed, limits: Dict,
          control=None, prog_scales=None):
    """``({"token_gap_mean": [value, limit]}, the port's numbers, the
    control's numbers, diagnostics)``: the mean over the sampled served tokens of their gap
    below the reference's best (the widest gap and the share of tokens off
    the best go to the diagnostics)."""
    lim = limits["numbers"]["token_gap_mean"]["limit"]
    picked = sample(done, seed, limits["sample_served_tokens"])
    scales = ref.calibrate(params, cfg, calib)
    diag = []
    if prog_scales is not None:
        rel = max(abs(a - b) / abs(b) for k in ("in", "out")
                  for a, b in zip(prog_scales[k], scales[k]))
        rel = max([rel] + [abs(prog_scales[k] - scales[k]) / abs(scales[k])
                           for k in ("conv", "head")])
        diag.append(f"scales: the port's within {rel!r} of the reference's")
    if not picked:
        return {"token_gap_mean": [float("inf"), lim]}, {}, {}, diag + [
            "no finished request to judge"]
    dec = ref.Decoder(params, cfg, scales)
    seqs = [list(r.prompt) + list(r.out) for r in picked]
    device = params["ln_f"]["scale"].device
    want = dec.teacher_forced(seqs, device)
    V = cfg["vocab"]
    margin = 1e-3 * max(float(lg[:, :V].abs().max()) for lg in want)
    got = _numbers(_gaps(torch, picked, want, None, V), margin)
    diag.append(f"judged {len(picked)} requests, "
                f"{sum(len(r.out) for r in picked)} served tokens: {got}")
    ctl = {}
    if control == "tf32":
        with tf32(torch):
            other = dec.teacher_forced(seqs, device)
        picks = [lg[len(r.prompt) - 1:len(r.prompt) - 1 + len(r.out), :V]
                 .argmax(-1) for r, lg in zip(picked, other)]
        ctl = _numbers(_gaps(torch, picked, want, picks, V), margin)
        diag.append(f"control {control}: {ctl}")
    return {"token_gap_mean": [got["token_gap_mean"], lim]}, got, ctl, diag
