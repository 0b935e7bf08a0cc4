#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the quickest
proof that the port still builds, agrees with itself and serves.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles the three CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) and prints the seconds;
3. checks: each kernel and variant (counters on/off, float32 and one
   bfloat16 case) against its plain PyTorch version on the same inputs, at
   the decode path's shapes and at a ragged small shape.  dwconv outputs
   and all counters must be exact; GEMVs on an exact grid (small-integer
   weights, power-of-two scale) bit-equal; other float32 GEMVs within
   ``|d| <= 1e-4 * max|plain| + 1e-4 * |plain|`` (another summation order
   over up to 768 rows), bfloat16 within 1e-2 (one bf16 rounding of the
   float32 sum).  The head runs on a 384-row pool, as the engine's;
4. timing: each kernel at the decode shapes — its device time, the plain
   version's, one PyTorch library call computing the same function, and
   the least time the card could take (bytes this run's data must move at
   3.35 TB/s).  ``ms`` is cold: L2 is flushed before every timed call, as
   on the decode path, where a step reads ~1 GB of table rows once each;
   the warm time of back-to-back calls is kept beside it;
5. serving: ``Engine(mamba2-130m full width and depth, slots=4,
   pcilt=True)`` with float32 tables converts (calibrate, build, CRC
   record, verify at load) and serves 4 requests of 8 new tokens; prints
   conversion seconds, peak memory, step time, tokens/s and the launches
   per step of each kernel (must be 144 / 24 / 1), then checks one decode
   step's logits against the dense fake-quant oracle (every layer and the
   head demoted, so no kernel runs on the oracle's side);
6. prints the kernels' JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Details also go to ``chiprun_out/chip_smoke.json``.  Weights are random
(seeded).  A card without room for the ~72 GiB of float32 tables fails
phase 5 with a message.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FLUSH_BYTES = 256 << 20  # > 5x the H100's 50 MB L2
REPLACES = {
    "gemv_stacked": "src/repro/kernels/pcilt_fused.py:372",
    "dwconv1d": "src/repro/kernels/pcilt_dwconv1d.py:192",
    "shared_gemv": "src/repro/kernels/pcilt_shared.py:109",
}
SOURCES = {
    "gemv_stacked": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "dwconv1d": "src/repro_torch/kernels/csrc/pcilt_dwconv1d.cu",
    "shared_gemv": "src/repro_torch/kernels/csrc/pcilt_shared_gemv.cu",
}
B = 4  # decode slots
#: the six projections of one layer at mamba2-130m width: (G, O)
PROJ_SHAPES = {"wz,wx": (384, 1536), "wB,wC": (384, 128), "wdt": (384, 24),
               "wo": (768, 768)}
LIB_NOTE = {"gemv_stacked": "torch.matmul(fake_quant(x), W_l)",
            "dwconv1d": "torch.einsum('bkc,kc->bc', fake_quant(win), w)",
            "shared_gemv": "torch.matmul(fake_quant(x), kernel_q)"}


class SmokeFailure(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------


def _device_times(prof):
    """``{key: device microseconds}`` of a profile's rows that ran on the
    device."""
    out = {}
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = getattr(row, "self_cuda_time_total", 0.0)
        if t > 0:
            out[row.key] = t
    return out


def _profile(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_times(prof)


class L2Flush:
    """Evicts the L2 cache by inverting a buffer five times its size.
    ``keys`` names the flush's own device kernels, which timings leave
    out."""

    def __init__(self, torch):
        self.buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        self.keys = set(_profile(torch, self))

    def __call__(self):
        self.buf.bitwise_not_()


def time_calls(torch, calls, flush, kernel=None, reps=5):
    """Per-call times (ms) of ``calls`` (zero-argument callables):
    ``ms``, the mean device time with L2 flushed before every call, and
    ``warm_ms`` back to back (both from the profiler: the named kernel's
    time, or every kernel's but the flush's for a composite call); and
    ``events_ms``, the median over ``reps`` of the wall rate of
    back-to-back calls on the device clock (CUDA events), host overhead
    included."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for c in calls:
            c()
        e.record()
        e.synchronize()
        ev.append(s.elapsed_time(e) / len(calls))

    def run(cold):
        for c in calls:
            if cold:
                flush()
            c()

    warm = _profile(torch, lambda: run(False))
    require(not flush.keys & set(warm),
            f"the timed calls run the L2 flush's kernel {flush.keys}")
    cold = _profile(torch, lambda: run(True))
    per_call = []
    for prof in (cold, warm):
        us = sum(t for k, t in prof.items()
                 if k not in flush.keys and (kernel is None or kernel in k))
        require(us > 0, "the profiler saw no device time")
        per_call.append(us / 1000.0 / len(calls))
    return {"ms": per_call[0], "warm_ms": per_call[1],
            "events_ms": statistics.median(ev)}


# ----------------------------------------------------------------------------
# phase 3 + 4: kernels against their plain versions, and their times
# ----------------------------------------------------------------------------


def close(torch, got, want, rtol, exact=False):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    mx = float(err.max()) if err.numel() else 0.0
    if exact:
        return mx, bool(torch.equal(got, want))
    bound = rtol * float(want.abs().max()) + rtol * want.abs()
    return mx, bool((err <= bound).all())


def check_kernels(torch, ops, core, report):
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(bits=4, symmetric=True)
    group = 2
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: 0.0 for k in REPLACES}

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * s

    def record(kernel, what, mx, ok, tol):
        errs[kernel] = max(errs[kernel], mx)
        report["checks"].append({"kernel": kernel, "case": what,
                                 "max_abs_err": mx, "tol": tol, "ok": ok})
        log(f"check {kernel:13s} {what:44s} max_abs_err={mx:.3e} "
            f"[{tol}] {'ok' if ok else 'FAIL'}")
        require(ok, f"{kernel} {what}: kernel disagrees with its plain version")

    def x_and_scale(n, rows=B):
        x = randn(rows, n, s=2.0)
        return x, float(scale_from_amax(0.8 * x.abs().max(), spec))

    # -- stacked GEMV: the decode shapes, one bf16 case, exact grid, ragged
    cases = [(f"{k} G{G} O{O}", rows_, G, O, torch.float32, False)
             for k, (G, O) in PROJ_SHAPES.items() for rows_ in (B,)]
    cases += [("wz,wx G384 O1536 bf16", B, 384, 1536, torch.bfloat16, False),
              ("wz,wx G384 O1536 exact grid", B, 384, 1536, torch.float32,
               True),
              ("ragged B3 G5 O130", 3, 5, 130, torch.float32, False),
              ("ragged B1 G7 O24 exact grid", 1, 7, 24, torch.float32, True)]
    for what, rows_, G, O, dt, exact in cases:
        L = 2
        x, scale = x_and_scale(G * group, rows_)
        if exact:
            w = torch.randint(-3, 4, (L, G * group, O), generator=gen,
                              device=dev).float()
            scale = 0.5
        else:
            w = randn(L, G * group, O, s=(G * group) ** -0.5)
        tabs = torch.stack([core.build_grouped_tables(w[l], spec, scale, group)
                            for l in range(L)]).to(dt)
        for stats in (False, True):
            got = ops.pcilt_fused_gemv_stacked(x, tabs, 1, spec, scale, group,
                                               with_stats=stats)
            want = ops.gemv_stacked_plain(x, tabs, 1, spec, scale, group,
                                          with_stats=stats)
            torch.cuda.synchronize()
            if stats:
                (got, gc, gr), (want, wc, wr) = got, want
                record("gemv_stacked", f"{what} counters", 0.0,
                       int(gc) == int(wc) and float(gr) == float(wr),
                       "count, ratio exact")
            rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
            mx, ok = close(torch, got, want, rtol, exact)
            record("gemv_stacked", f"{what} counters={int(stats)}", mx, ok,
                   "exact" if exact else f"rtol {rtol}")
        del tabs, w

    # -- dwconv: decode window [4, 4, 1792] VALID, f32 + bf16, ragged CAUSAL
    for what, (Bq, T, C), pad, dt in [
            ("window B4 k4 C1792 VALID", (B, 4, 1792), "VALID", torch.float32),
            ("window B4 k4 C1792 VALID bf16", (B, 4, 1792), "VALID",
             torch.bfloat16),
            ("ragged B3 T9 C33 CAUSAL", (3, 9, 33), "CAUSAL", torch.float32)]:
        filt = randn(4, C, s=0.5)
        x = randn(Bq, T, C, s=2.0)
        scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
        tabs = core.build_dwconv_tables(filt, spec, scale).to(dt)
        xp = torch.nn.functional.pad(x, (0, 0, 3, 0)) if pad == "CAUSAL" else x
        for stats in (False, True):
            got = ops.pcilt_fused_dwconv1d(x, tabs, spec, scale, 4, pad,
                                           with_stats=stats)
            want = ops.dwconv1d_plain(xp, tabs, spec, scale, 4,
                                      with_stats=stats)
            torch.cuda.synchronize()
            if stats:
                (got, gc, gr), (want, wc, wr) = got, want
                record("dwconv1d", f"{what} counters", 0.0,
                       int(gc) == int(wc) and float(gr) == float(wr),
                       "count, ratio exact")
            mx, ok = close(torch, got, want, 0.0, exact=True)
            record("dwconv1d", f"{what} counters={int(stats)}", mx, ok,
                   "exact")
        del tabs

    # -- shared-pool head: [4, 768] x, G = 384, O = 50288 (ragged), the
    #    engine's pool of 384 distinct segments (18.4 GiB in float32), f32 +
    #    bf16 + exact grid; ragged, with each segment twice (X = G / 2)
    for what, rows_, G, O, dt, exact, dup in [
            ("head B4 G384 X384 O50288", B, 384, 50288, torch.float32,
             False, False),
            ("head B4 G384 X384 O50288 bf16", B, 384, 50288,
             torch.bfloat16, False, False),
            ("head B4 G384 X384 O50288 exact grid", B, 384, 50288,
             torch.float32, True, False),
            ("ragged B2 G6 X3 O7", 2, 6, 7, torch.float32, False, True)]:
        x, scale = x_and_scale(G * group, rows_)
        n_blk = (G // 2 if dup else G) * group
        if exact:
            blocks = torch.randint(-3, 4, (n_blk, O), generator=gen,
                                   device=dev).float()
            scale = 0.5
        else:
            blocks = randn(n_blk, O, s=0.05)
        if dup:
            blocks = torch.cat([blocks, blocks])
        shared = core.build_shared_grouped_tables(blocks, spec, scale, group)
        pool, idx = shared.pool.to(dt), shared.seg_idx
        del shared, blocks
        require(pool.shape[0] == (G // 2 if dup else G),
                f"{what}: pool has {pool.shape[0]} rows")
        got = ops.pcilt_shared_gemv(x, pool, idx, spec, scale, group)
        want = ops.shared_gemv_plain(x, pool, idx, spec, scale, group)
        torch.cuda.synchronize()
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        mx, ok = close(torch, got, want, rtol, exact)
        record("shared_gemv", what, mx, ok,
               "exact" if exact else f"rtol {rtol}")
        del pool
    return errs


def time_kernels(torch, ops, core, report):
    """Per-launch device time of each kernel at the decode shapes, beside
    its plain version, a library call and the least time the card could
    take."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               quantize, scale_from_amax)

    dev = torch.device("cuda")
    spec = QuantSpec(bits=4, symmetric=True)
    group, L = 2, 8
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = L2Flush(torch)
    rows = {}

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel)

    def add(key, kernel, shape, k, plain, lib, bound_ms, launches_per_step):
        rows[key] = {"kernel": kernel, "shape": shape, "ms": k["ms"],
                     "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
                     "plain_ms": plain["ms"], "plain_warm_ms": plain["warm_ms"],
                     "library_ms": lib["ms"], "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "launches_per_step": launches_per_step}
        log(f"time  {kernel:13s} {key:26s} kernel {k['ms'] * 1e3:8.2f} us "
            f"(warm {k['warm_ms'] * 1e3:8.2f}, events "
            f"{k['events_ms'] * 1e3:8.2f})  plain {plain['ms'] * 1e3:8.2f} us"
            f"  library {lib['ms'] * 1e3:8.2f} us (warm "
            f"{lib['warm_ms'] * 1e3:8.2f})  bound {bound_ms * 1e3:7.2f} us  "
            f"x{launches_per_step}/step")

    def scale_for(x):
        return float(scale_from_amax(0.8 * x.abs().max(), spec))

    # -- stacked GEMV at each projection shape, in the variants a decode step
    #    launches: (shape, counters) -> launches per step (wx and wo count)
    per_step = {("wz,wx", False): 24, ("wz,wx", True): 24,
                ("wB,wC", False): 48, ("wdt", False): 24, ("wo", True): 24}
    for key, (G, O) in PROJ_SHAPES.items():
        n = G * group
        w = torch.randn(L, n, O, generator=gen, device=dev) * n ** -0.5
        x = torch.randn(B, n, generator=gen, device=dev)
        scale = scale_for(x)
        tabs = torch.empty((L, G, 256, O), device=dev)
        for l in range(L):
            tabs[l] = core.build_grouped_tables(w[l], spec, scale, group)
        off = pack_offsets(quantize(x, spec, scale), spec.bits, group)
        uniq_rows = sum(len(torch.unique(off[:, g])) for g in range(G))
        bound = (uniq_rows * O * 4 + x.numel() * 4 + B * O * 4) \
            / HBM_BYTES_PER_S * 1e3
        xq = fake_quant(x, spec, scale)
        lib = timed([lambda l=l: torch.matmul(xq, w[l]) for l in range(L)] * 4)
        for stats in (False, True):
            if (key, stats) not in per_step:
                continue
            calls = [lambda l=l: ops.pcilt_fused_gemv_stacked(
                x, tabs, l, spec, scale, group, with_stats=stats)
                for l in range(L)] * 4
            plain = [lambda l=l: ops.gemv_stacked_plain(
                x, tabs, l, spec, scale, group, with_stats=stats)
                for l in range(L)] * 2
            k = timed(calls, "gemv_stacked_kernel")
            p = timed(plain)
            add(f"{key}{' counters' if stats else ''}", "gemv_stacked",
                [L, G, 256, O], k, p, lib, bound, per_step[(key, stats)])
        del tabs, w

    # -- dwconv over the [4, 4, 1792] decode window (counters: the engine's)
    C = 1792
    filt = torch.randn(L, 4, C, generator=gen, device=dev) * 0.5
    win = torch.randn(B, 4, C, generator=gen, device=dev)
    scale = scale_for(win)
    tabs = torch.empty((L, C, 1 << 16), device=dev)
    for l in range(L):
        tabs[l] = core.build_dwconv_tables(filt[l], spec, scale)
    codes = quantize(win, spec, scale).int()
    off = sum(codes[:, j] << (4 * j) for j in range(4))  # [B, C]
    uniq = sum(len(torch.unique(off[:, c])) for c in range(C))
    bound = (uniq * 32 + win.numel() * 4 + B * C * 4) / HBM_BYTES_PER_S * 1e3
    wq = fake_quant(win, spec, scale)
    lib = timed([lambda l=l: torch.einsum("bkc,kc->bc", wq, filt[l])
                 for l in range(L)] * 4)
    k = timed([lambda l=l: ops.pcilt_fused_dwconv1d(
        win, tabs[l], spec, scale, 4, "VALID", with_stats=True)
        for l in range(L)] * 4, "dwconv1d_kernel")
    p = timed([lambda l=l: ops.dwconv1d_plain(
        win, tabs[l], spec, scale, 4, with_stats=True)
        for l in range(L)] * 2)
    add("window counters", "dwconv1d", [L, C, 1 << 16], k, p, lib, bound, 24)
    del tabs

    # -- shared-pool head: the engine's pool of 384 distinct segments
    #    (18.4 GiB), x rotating over 4 inputs
    G, O = 384, 50288
    blocks = torch.randn(G * group, O, generator=gen, device=dev) * 0.05
    xs = [torch.randn(B, G * group, generator=gen, device=dev)
          for _ in range(4)]
    scale = scale_for(xs[0])
    shared = core.build_shared_grouped_tables(blocks, spec, scale, group)
    pool, idx = shared.pool, shared.seg_idx
    X = pool.shape[0]
    require(X == G, f"head pool has {X} rows, the engine's {G}")
    kq = torch.randn(G * group, O, generator=gen, device=dev) * 0.05
    rows_ = 0
    for x in xs:
        o = pack_offsets(quantize(x, spec, scale), spec.bits, group)
        rows_ += len(torch.unique(idx.long()[None] * 256 + o.long()))
    bound = (rows_ / len(xs) * O * 4 + xs[0].numel() * 4 + G * 4
             + B * O * 4) / HBM_BYTES_PER_S * 1e3
    xqs = [fake_quant(x, spec, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, kq) for q in xqs] * 4)
    k = timed([lambda x=x: ops.pcilt_shared_gemv(
        x, pool, idx, spec, scale, group) for x in xs] * 4,
        "shared_gemv_kernel")
    p = timed([lambda x=x: ops.shared_gemv_plain(
        x, pool, idx, spec, scale, group) for x in xs] * 2)
    add("head", "shared_gemv", [X, 256, O], k, p, lib, bound, 1)
    del pool, shared, blocks, flush
    report["timing"] = rows
    return rows


# ----------------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------------


def serve(torch, ops, report):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.launch.serve import Engine, make_requests

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=4, group=2),
                              dtype=torch.float32)
    d_inner = 2 * cfg.d_model
    G_in, V = cfg.d_model // 2, 256
    proj_cells = cfg.n_layers * V * (
        G_in * (2 * d_inner + 2 * cfg.ssm.d_state + d_inner // 64)
        + (d_inner // 2) * cfg.d_model)
    conv_bytes = cfg.n_layers * (d_inner + 2 * cfg.ssm.d_state) * (1 << 16) * 4
    head_bytes = G_in * V * cfg.padded_vocab * 4  # 384 distinct segments
    free, total = torch.cuda.mem_get_info()
    need = proj_cells * 4 + conv_bytes + head_bytes
    log(f"tables: {need / 2**30:.1f} GiB in float32 against "
        f"{free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB")
    require(need + (3 << 30) <= free,
            f"the card has {free / 2**30:.1f} GiB free; the float32 tables "
            f"need {need / 2**30:.1f} GiB plus ~2 GiB of working memory")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=B, pcilt=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    conv = dict(eng.convert_timings)
    log(f"engine: set-up {setup_s:.1f} s; conversion "
        + ", ".join(f"{k} {v:.1f}" for k, v in conv.items())
        + f"; table bytes {eng.pdecode.table_bytes() / 2**30:.2f} GiB")
    reqs = make_requests(cfg, 4, 8, seed=0)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    per_step = {k: v / steps for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(eng.step_seconds)
    gen_tokens = sum(len(r.out) for r in reqs)
    log(f"served {stats['served']}/{len(reqs)} requests: {steps} steps "
        f"({stats['prefill_ticks']} prefill, {stats['decode_ticks']} decode) "
        f"in {stats['wall_s']:.2f} s; median step {med * 1e3:.2f} ms "
        f"({B / med:.1f} tokens/s over {B} slots; {gen_tokens} generated "
        f"tokens at {gen_tokens / stats['wall_s']:.1f} tokens/s end to end)")
    log(f"peak memory allocated {peak / 2**30:.2f} GiB")
    log("launches per step: " + ", ".join(f"{k} {v:g}"
                                          for k, v in per_step.items()))
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == len(reqs), "not every request was served")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), "generated tokens out of range")
    require(per_step == {"gemv_stacked": 144, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"main path did not run through the kernels: {per_step}")
    report["serve"] = {"setup_s": setup_s, "convert": conv,
                       "peak_bytes": peak, "steps": steps,
                       "median_step_s": med, "step_seconds": eng.step_seconds,
                       "wall_s": stats["wall_s"], "tokens": gen_tokens,
                       "launches": launches, "launches_per_step": per_step,
                       "table_bytes": eng.pdecode.table_bytes(),
                       "outputs": [r.out for r in reqs]}
    oracle_check(torch, ops, eng, report)
    return launches


def oracle_check(torch, ops, eng, report):
    """One decode step through the kernels against the dense fake-quant
    oracle on the same state: every layer and the head demoted, so each
    projection is a float32 matmul on fake-quantized inputs, each conv an
    einsum on the fake-quantized window and the head ``fake_quant(x) @
    kernel_q``; the oracle's step launches no kernel.  The fetch is exact on
    the grid, so the two differ by float32 summation order (and any
    quantization code that order tips over a rounding boundary downstream):
    allclose at 1e-3 relative to the largest logit, and argmax-equal
    wherever the oracle's top two logits are further apart than that
    tolerance (the head's logits lie on a coarse grid and can tie)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                       device="cuda") * 0.1
                        for k, t in eng.cache["layers"].items()}}
    tok = torch.randint(0, eng.cfg.vocab, (B, 1), generator=gen,
                        device="cuda")
    bundle = eng.pdecode.pcilt
    with torch.no_grad():
        got, _ = eng.model.decode_step(eng.params, cache, tok, pcilt=bundle)
        before = dict(ops.LAUNCHES)
        want, _ = eng.model.decode_step(
            eng.params, cache, tok, pcilt=bundle,
            layer_ok=[False] * eng.cfg.n_layers, head_ok=False)
    require(dict(ops.LAUNCHES) == before,
            "the dense oracle's step launched a kernel")
    V = eng.cfg.vocab
    got, want = got[:, :V].float(), want[:, :V].float()
    tol = 1e-3 * float(want.abs().max())
    err = float((got - want).abs().max())
    top2 = want.topk(2, -1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    agree = got.argmax(-1) == want.argmax(-1)
    tie_ok = want.gather(1, got.argmax(-1, keepdim=True))[:, 0] >= \
        top2[:, 0] - tol
    log(f"oracle: max |logit - oracle| {err:.3e} (tol {tol:.3e}, max |logit| "
        f"{float(want.abs().max()):.3f}); argmax equal on "
        f"{int(agree.sum())}/{B} rows, near-ties {int((~decided).sum())}")
    report["oracle"] = {"max_abs_err": err, "tol": tol,
                        "argmax_equal": int(agree.sum()),
                        "near_ties": int((~decided).sum())}
    require(bool(torch.isfinite(got).all()), "non-finite logits")
    require(err <= tol, "decode step disagrees with the dense oracle")
    require(bool((agree | (~decided & tie_ok)).all()),
            "greedy token differs from the dense oracle's")


# ----------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 oracles stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log(card)
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "checks": []}

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc, 3 sources in parallel)")
    for name, text in build.build_log().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in build.SOURCES:
        build.library(name)

    errs = check_kernels(torch, ops, core, report)
    torch.cuda.empty_cache()
    rows = time_kernels(torch, ops, core, report)
    torch.cuda.empty_cache()
    launches = serve(torch, ops, report)

    primary = {"gemv_stacked": "wz,wx", "dwconv1d": "window counters",
               "shared_gemv": "head"}
    kernels = []
    for name, key in primary.items():
        r = rows[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
