#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the quickest
proof that the port still builds, agrees with itself and serves.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
3. checks: each kernel and variant (counters on/off, float32 and one
   bfloat16 case) against its plain PyTorch version on the same inputs, at
   the decode path's shapes and at a ragged small shape.  dwconv outputs
   and all counters must be exact; GEMVs on an exact grid (small-integer
   weights, power-of-two scale) bit-equal; other float32 GEMVs within
   ``|d| <= 1e-4 * max|plain| + 1e-4 * |plain|`` (another summation order
   over up to 3072 rows), bfloat16 within 1e-2 (one bf16 rounding of the
   float32 sum).  The head runs on a 384-row pool, as the engine's.  The
   conv and host-packed kernels (fused_conv2d, shared_conv2d, gemv_host,
   conv2d_host) run the paper CNN's five layer shapes on a 64x48 image and
   ragged shapes (stride 2, symmetric 4-bit, group 2 with odd C, O = 13,
   bf16, a pool pointer out of range, V = 65536); the fused and shared
   conv in both designs — the staged kernel (its code pre-pass exact, two
   launches bit-identical) and the kept one, forced.  The paired stacked
   GEMV runs the
   paired decode's wz and wo on 24-layer segment-major stacks, the paired
   and fused GEMVs the parity probe's and qwen3-0.6b's MLP shapes, the
   host-packed dwconv the single-layer signal's offsets, each with a
   ragged case (odd G with its phantom segment, O = 13, offsets out of
   range); the plan GEMV (kernel 11) qwen3-0.6b's gate under phase 10's
   permutation plan, an exact grid with a -1 slot and a reused position,
   and a ragged plan (odd G, n != G*group, O = 13);
4. timing: each kernel at its main path's shapes — its device time, the
   plain version's, one PyTorch library call computing the same function,
   and the least time the card could take (the larger of the bytes this
   run's data must move at 3.35 TB/s and the fetch-adds at 67 TFLOP/s
   float32).  Every time is device time from ``torch.profiler`` (a
   profile that misses a launch is taken again, up to three times, then
   the script fails).  ``ms`` is cold: L2 is flushed before every timed
   call, as on the decode path, where a step reads ~1 GB of table rows
   once each; the warm time of back-to-back calls is kept beside it.  The
   conv kernels run each layer of the paper CNN at B = 1, 1024x768 on its
   real input (the fused and shared conv: the staged design, its pre-pass
   and fetch summed, beside the kept design forced and the fetch floor
   from the SM count and ``clocks.max.sm``); their plain versions on a
   64x48 crop;
5. serving: ``Engine(mamba2-130m full width and depth, slots=4,
   pcilt=True)`` with float32 tables converts (calibrate, build, CRC
   record, verify at load) and serves 4 requests of 8 new tokens; prints
   conversion seconds, table bytes, the head pool's bytes, peak memory,
   step time, tokens/s and the launches per step of each kernel (must be
   144 / 24 / 1), then checks one decode step's logits against the dense
   fake-quant oracle (every layer and the head demoted, so no kernel runs
   on the oracle's side);
6. the paper CNN (``configs/paper_cnn.config()``: 50-80-120-200-350
   channels, 5x5, INT8) on one seeded 1024x768 image: tables built on the
   card (2.57 GiB float32), a 256x192 forward timed and extrapolated
   first, then ``forward(mode="fused")`` (5 fused_conv2d launches), the
   extension-3 network of ``convert_conv_kernel(shared=True,
   weight_bits=4)`` layers (5 shared_conv2d launches) and, on a 256x192
   image, ``forward(mode="kernel")`` (5 gemv_host launches); per-layer
   device ms and design (staged or kept), forward ms, images/s, table
   bytes and peak memory; each
   layer against ``F.conv2d`` on its fake-quantized input, and each
   path's logits against direct multiplication (rtol = atol = 1e-3,
   argmax equal), with the codes flipped between the two chains;
7. the paired (TL1) decode at full width and depth: mamba2-130m with
   ``PCILTConfig(act_bits=2, group=2)``, float32 segment-major stacks
   (21.5 GiB) and the shared-pool head, built by
   ``convert_mamba_decode(paired=True)`` and served by
   ``Engine(pcilt_bundle=...)`` (4 requests of 8 new tokens, sentinel on;
   144 / 24 / 1 launches of the paired stacked GEMV, the dwconv and the
   head per step); conversion seconds, table bytes, peak memory, the
   oracle check of phase 5, and the median of three B = 4 steps dense,
   unpaired (kernel 1) and paired (kernel 8) with each step's device time;
8. the exact-grid paired parity probe: ``pcilt_linear(path="fused")`` on
   ``[G, V, O]`` and ``pcilt_linear(paired=True, path="fused")`` on
   ``[G2, V2, O]`` bit-equal at ``[4, 64] -> 128`` and ``[4, 768] ->
   1536``;
9. single layers at full published widths: ``convert_kernel`` ->
   ``PCILTLinear(path="fused")`` on qwen3-0.6b's MLP (1024 -> 3072 ->
   1024, 4-bit, group 2; 1.61 GB of float32 tables per projection) against
   the dense product on the quantized grid, and ``convert_dwconv`` ->
   ``PCILTDwConv1d(path="kernel")`` on mamba2-130m's conv frontend (C 1792,
   k 4, 2-bit) over a [4, 2048, 1792] signal against the fused path and
   its plain version;
10. the paper's extensions 1-3 at qwen3-0.6b's gate width (1024 -> 3072,
    4-bit, group 2, float32 tables, one set at a time): three generalized
    SegmentPlans (``perm``, a seeded permutation into 512 non-adjacent
    pairs; ``pruned``, the 895 largest-norm positions with one -1 slot, G
    448; ``reuse``, the contiguous plan plus 64 segments repeating the 128
    largest-norm positions, G 576) through ``pcilt_linear(plan=,
    path="fused")`` (kernel 11) against its plain version, ``path="kernel"``
    and the dense oracle (1e-4 of the largest output), ``perm`` bit-equal
    to kernel 9 on ``x[:, perm]``, an exact-grid plan probe bit-equal
    across the three; ``log_mul_fn`` tables (extension 2) through kernel 9
    against the gather path and the direct sum; scalar ``SharedTables`` of
    the 4-bit-quantized gate (extension 3) through ``path="shared"``
    (kernel 3 at group 1) against ``materialize()`` and the dense product;
11. learnable tables (extension 4): ``launch.learnable_pcilt.run()``, every
    granularity's loss falling and finite and within 1e-4 of the same run
    on the CPU, each trained table served through kernel 6 equal to the
    gather path;
12. prints the kernels' JSON line, then as the last line
    ``{"ok": true, "device": {...}}``.

Each path's launches are counted from 0 just before it runs.
Details also go to ``chiprun_out/chip_smoke.json``.  Weights are random
(seeded).  A card without room for the ~72 GiB of float32 tables fails
phase 5 with a message; phase 5's tables are freed before phase 6.
"""

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 << 20  # > 5x the H100's 50 MB L2
FLUSH_KERNEL = "bitwise_not"  # in the name of the flush's device kernel
PROFILE_PAD_S = 0.02  # host idle time on each side of a profiled window
REPLACES = {
    "gemv_stacked": "src/repro/kernels/pcilt_fused.py:372",
    "dwconv1d": "src/repro/kernels/pcilt_dwconv1d.py:192",
    "shared_gemv": "src/repro/kernels/pcilt_shared.py:109",
    "fused_conv2d": "src/repro/kernels/pcilt_fused.py:756",
    "shared_conv2d": "src/repro/kernels/pcilt_shared.py:182",
    "gemv_host": "src/repro/kernels/pcilt_gemv.py:75",
    "conv2d_host": "src/repro/kernels/pcilt_conv2d.py:55",
    "gemv_paired_stacked": "src/repro/kernels/pcilt_fused.py:518",
    "fused_gemv": "src/repro/kernels/pcilt_fused.py:138",
    "gemv_paired": "src/repro/kernels/pcilt_fused.py:231",
    "dwconv1d_host": "src/repro/kernels/pcilt_dwconv1d.py:61",
    "gemv_plan": "src/repro/kernels/pcilt_fused.py:636",
}
SOURCES = {
    "gemv_stacked": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "dwconv1d": "src/repro_torch/kernels/csrc/pcilt_dwconv1d.cu",
    "shared_gemv": "src/repro_torch/kernels/csrc/pcilt_shared_gemv.cu",
    "fused_conv2d": "src/repro_torch/kernels/csrc/pcilt_conv2d.cu",
    "shared_conv2d": "src/repro_torch/kernels/csrc/pcilt_conv2d.cu",
    "gemv_host": "src/repro_torch/kernels/csrc/pcilt_gemv.cu",
    "conv2d_host": "src/repro_torch/kernels/csrc/pcilt_gemv.cu",
    "gemv_paired_stacked": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "fused_gemv": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "gemv_paired": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
    "dwconv1d_host": "src/repro_torch/kernels/csrc/pcilt_dwconv1d.cu",
    "gemv_plan": "src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu",
}
#: device kernel names (a substring of each) in profiles
GEMV_KERNEL = "gemv_fused_kernel"
#: the staged conv design's two launches (code pre-pass, fetch), and the
#: kept design's one
STAGED_KERNELS = ("conv2d_codes_kernel", "conv2d_staged_kernel")
DIRECT_KERNEL = "conv2d_kernel"
#: shared memory / L1 data path of one SM, bytes a clock (the conv fetch
#: floor's rate)
SMEM_BYTES_PER_CLOCK = 128
DWCONV_HOST_KERNEL = "dwconv1d_host_kernel"
B = 4  # decode slots
#: the six projections of one layer at mamba2-130m width: (G, O)
PROJ_SHAPES = {"wz,wx": (384, 1536), "wB,wC": (384, 128), "wdt": (384, 24),
               "wo": (768, 768)}
#: the paired decode (act_bits 2, group 2): pairs G2 and outputs O of wz
#: and wo, and its layer count (the stride of the segment-major stacks)
PAIRED_SHAPES = {"wz": (192, 1536), "wo": (384, 768)}
N_LAYERS = 24
#: qwen3-0.6b's MLP (src/repro/configs/qwen3_06b.py): d_model, d_ff
QWEN_D, QWEN_FF = 1024, 3072
#: mamba2-130m's conv frontend: channels, taps; the single-layer signal
CONV_C, CONV_K, CONV_T = 1792, 4, 2048
LIB_NOTE = {"gemv_stacked": "torch.matmul(fake_quant(x), W_l)",
            "dwconv1d": "torch.einsum('bkc,kc->bc', fake_quant(win), w)",
            "shared_gemv": "torch.matmul(fake_quant(x), kernel_q)",
            "fused_conv2d": "F.conv2d(fake_quant(xp), w), cuDNN, TF32 off",
            "shared_conv2d": "F.conv2d(fake_quant(xp), w_q), cuDNN, TF32 off",
            "gemv_host": "F.embedding_bag(off + g*V, T.view(G*V, O), "
                         "mode='sum')",
            "conv2d_host": "F.embedding_bag(off + g*V, T.view(G*V, O), "
                           "mode='sum')",
            "gemv_paired_stacked": "torch.matmul(fake_quant(x), W_l)",
            "fused_gemv": "torch.matmul(fake_quant(x), W)",
            "gemv_paired": "torch.matmul(fake_quant(x), W)",
            "dwconv1d_host": "torch.take(T, c*V + off)",
            "gemv_plan": "torch.matmul(fake_quant(x)[:, plan], W[plan])"}
#: the paper CNN's image (H, W) at full size (printed W x H, as the paper), and the small image of the
#: checks and of the plain versions' timing
FULL_HW = (768, 1024)
SMALL_HW = (48, 64)
#: the host-packed path's image in phase 6: its patches and offsets at full
#: size would take about 31 GB
KERNEL_HW = (192, 256)


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
    """``{key: (launches, device microseconds)}`` of a profile's rows that
    ran on the device."""
    out = {}
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = getattr(row, "self_cuda_time_total", 0.0)
        if t > 0:
            out[row.key] = (row.count, t)
    return out


def _profile(torch, fn):
    """Device times of ``fn()``.  The window is padded with host idle time
    on both sides, so the device's records lie well inside it (records of
    a short window at its edges can fall outside the window the profiler
    keeps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return _device_times(prof)


class L2Flush:
    """Evicts the L2 cache by inverting a buffer five times its size.  Its
    device kernel (``FLUSH_KERNEL`` in the name) is left out of timings."""

    def __init__(self, torch):
        self.buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.bitwise_not_()


def time_calls(torch, calls, flush, kernel=None, reps=5, warmup=2,
               retries=None, launches_per_call=1):
    """Per-call times (ms) of ``calls`` (zero-argument callables), all
    profiler device time: ``ms``, the mean with L2 flushed before every
    call, and ``warm_ms`` back to back (the named kernels' time, each call
    ``launches_per_call`` launches of them — ``kernel`` is a name or a tuple of
    names; or, for a composite call, every kernel's but the flush's); and
    ``events_ms``, the median over ``reps`` of the wall rate of
    back-to-back calls on the device clock (CUDA events), host overhead
    included.  ``warmup`` calls run first.  A profile that misses a launch
    of the named kernels, or shows no device time, is taken again (counted
    in ``retries``), up to three times; then the script fails."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    for c in calls[:warmup]:
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

    per_call = []
    for cold in (True, False):
        for attempt in range(3):
            prof = _profile(torch, lambda: run(cold))
            flushes = [k for k in prof if FLUSH_KERNEL in k]
            require(cold or not flushes,
                    f"the timed calls run the L2 flush's kernel {flushes}")
            mine = [v for k, v in prof.items() if FLUSH_KERNEL not in k
                    and (names is None or any(m in k for m in names))]
            n, us = sum(c for c, _ in mine), sum(t for _, t in mine)
            if us > 0 and (names is None
                           or n == len(calls) * launches_per_call):
                per_call.append(us / 1000.0 / len(calls))
                break
            if retries is not None:
                retries.append({"kernel": kernel, "cold": cold,
                                "launches_seen": n,
                                "of": len(calls) * launches_per_call})
            log(f"  (profile {attempt + 1} saw {n} of "
                f"{len(calls) * launches_per_call} launches"
                f" of {kernel or 'the calls'}, {us:.1f} us: taken again; "
                f"rows {[(k[:48], c) for k, (c, _) in prof.items()]})")
        else:
            raise SmokeFailure(f"the profiler missed launches of "
                               f"{kernel or 'the calls'} three times")
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
    check_conv_kernels(torch, ops, record, gen)
    check_slice3_kernels(torch, ops, record, gen)
    check_plan_kernel(torch, ops, record, gen)
    return errs


def conv_layers(cfg):
    """``(Cin, Cout)`` of each conv layer of a ``PaperCNN``."""
    return list(zip((cfg.in_channels,) + tuple(cfg.channels[:-1]),
                    cfg.channels))


def padded(x, k, stride):
    from repro_torch.core.lut_layers import conv_same_pads, pad_nhwc

    return pad_nhwc(x, conv_same_pads(x.shape[1], x.shape[2], k, k, stride))


def check_conv_kernels(torch, ops, record, gen):
    """The conv and host-packed kernels against their plain versions (run
    on the card): the paper's five layer shapes on a 64x48 image (8-bit
    asymmetric, group 1), one of them on an exact grid and one in bf16;
    ragged shapes (stride 2, symmetric 4-bit, group 2 with odd C so the
    alignment slot n_pad is 1, O = 13 or 45, a pool of X < G rows with one
    pointer out of range), f32, bf16 and exact.  The fused and shared conv
    run both designs on every case: the staged kernel (the wrappers'
    choice at V = 256; its code pre-pass held to its plain version
    exactly, and two launches bit-identical) and the kept kernel, forced;
    a V = 65536 case (8 bits x group 2) takes the kept kernel unforced.
    Exact grid: bit-equal; f32 within 1e-4 of max|plain| (another
    summation order over up to 5000 rows); bf16 within 1e-2 (one rounding
    of the f32 sum)."""
    from repro_torch.configs.paper_cnn import config
    from repro_torch.core.lut_layers import conv_offsets, flatten_filters
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import QuantSpec, calibrate
    from repro_torch.kernels.ref import pcilt_conv2d_ref, pcilt_gemv_ref

    dev = torch.device("cuda")
    cfg = config()
    k = cfg.k
    H, W = SMALL_HW
    cases = [(f"conv{i} {W}x{H} C{c} O{o}", c, o, cfg.act_spec, 1, 1, H, W,
              torch.float32, False, False)
             for i, (c, o) in enumerate(conv_layers(cfg))]
    sym4 = QuantSpec(4, symmetric=True)
    cases += [(f"conv1 {W}x{H} exact grid", 50, 80, cfg.act_spec, 1, 1, H, W,
               torch.float32, True, False),
              (f"conv2 {W}x{H} bf16", 80, 120, cfg.act_spec, 1, 1, H, W,
               torch.bfloat16, False, False),
              ("ragged s2 sym4 g2 C3 O13 9x11", 3, 13, sym4, 2, 2, 9, 11,
               torch.float32, False, True),
              ("ragged s2 sym4 g2 C3 O13 9x11 bf16", 3, 13, sym4, 2, 2, 9, 11,
               torch.bfloat16, False, True),
              ("ragged s2 sym4 g2 C5 O45 13x10 exact", 5, 45, sym4, 2, 2, 13,
               10, torch.float32, True, True),
              ("large V: 8-bit g2 C3 O13 9x11", 3, 13, cfg.act_spec, 2, 1, 9,
               11, torch.float32, False, True)]
    for what, C, O, spec, group, stride, h, w_, dt, exact, ragged in cases:
        if spec.symmetric:
            x = torch.randn(1, h, w_, C, generator=gen, device=dev)
        else:
            x = torch.rand(1, h, w_, C, generator=gen, device=dev) * 2
        if exact:
            w = torch.randint(-3, 4, (k, k, C, O), generator=gen,
                              device=dev).float()
            scale = 0.5
        else:
            w = torch.randn(k, k, C, O, generator=gen, device=dev) \
                * (k * k * C) ** -0.5
            scale = float(calibrate(x, spec))
        tabs = build_grouped_tables(flatten_filters(w, group), spec, scale,
                                    group).to(dt)
        G = tabs.shape[0]
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        tol = "exact" if exact else f"rtol {rtol}"
        xp = padded(x, k, stride)

        def check(kernel, got, want, note=""):
            torch.cuda.synchronize()
            mx, ok = close(torch, got, want.reshape(got.shape), rtol, exact)
            record(kernel, what + note, mx, ok, tol)

        if ragged:  # a pool of X < G rows, one pointer out of range
            X = G // 2
            pool = tabs[:X]
            idx = torch.randint(0, X, (G,), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[G // 3] = X + 7
        else:
            pool, idx = tabs, torch.arange(G, dtype=torch.int32, device=dev)
        fits = ops.conv_variant(tabs.shape[1], tabs.element_size())
        for kernel, run, plain in (
                ("fused_conv2d", lambda v: ops._fused_conv2d(
                    x, tabs, spec, scale, group, k, k, stride, variant=v),
                 ops.fused_conv2d_plain(xp, tabs, spec, scale, group, k, k,
                                        stride)),
                ("shared_conv2d", lambda v: ops._shared_conv2d(
                    x, pool, idx, spec, scale, group, k, k, stride,
                    variant=v),
                 ops.shared_conv2d_plain(xp, pool, idx, spec, scale, group,
                                         k, k, stride))):
            seen = dict(ops.CONV_VARIANT_LAUNCHES)
            got = run(None)  # the wrappers' choice
            diff = {v: c - seen[v] for v, c in
                    ops.CONV_VARIANT_LAUNCHES.items() if c != seen[v]}
            require(diff == {fits: 1}, f"{kernel} {what}: ran {diff}, "
                    f"conv_variant chose {fits}")
            check(kernel, got, plain)
            if fits == "staged":
                again = run("staged")
                torch.cuda.synchronize()
                require(torch.equal(got, again), f"{kernel} {what}: two "
                        "launches of the staged kernel differ")
                check(kernel, run("direct"), plain, " kept kernel")
        if fits == "staged":
            codes = ops._conv_codes(xp, spec, scale)
            torch.cuda.synchronize()
            want = ops.conv_codes_plain(xp, spec, scale)
            record("fused_conv2d", f"{what} code pre-pass", 0.0 if
                   torch.equal(codes, want) else float("inf"),
                   torch.equal(codes, want), "exact")
        off = conv_offsets(xp, spec, scale, group, k, k, stride, "VALID")
        check("gemv_host", ops.pcilt_gemv(off.reshape(-1, G), tabs),
              pcilt_gemv_ref(off.reshape(-1, G), tabs))
        check("conv2d_host", ops.pcilt_conv2d(off, tabs),
              pcilt_conv2d_ref(off, tabs))
        del tabs, pool, off


def check_slice3_kernels(torch, ops, record, gen):
    """The paired stacked GEMV, the unstacked fused and paired GEMVs and the
    host-packed dwconv against their plain versions (run on the card).

    Paired stacked: the paired decode's wz and wo at B = 4 on segment-major
    ``[G2, 24, 256, O]`` stacks, layer 23 (element offsets up to 1.8e9),
    float32, bfloat16 and an exact grid; ragged: odd G (the phantom
    segment), O = 13, B = 3.  Paired: the parity probe's shapes, bf16,
    ragged.  Fused: qwen3-0.6b's gate and down projections, bf16, exact
    grid, ragged.  Counters bit-exact.  Exact grid: bit-equal; float32
    within 1e-4 of max|plain| (sums over up to 1536 rows); bfloat16 within
    1e-2 (one rounding of the float32 sum).  Host dwconv: exact, with
    offsets outside [0, V) giving 0."""
    import torch.nn.functional as F

    from repro_torch.core.pcilt import (build_grouped_tables,
                                        build_paired_stacked_tables,
                                        build_paired_tables)
    from repro_torch.core.quantization import QuantSpec, scale_from_amax
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    dev = torch.device("cuda")
    group = 2
    spec2, spec4 = QuantSpec(2, True), QuantSpec(4, True)

    def weights(shape, exact):
        if exact:
            return torch.randint(-3, 4, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev) \
            * shape[-2] ** -0.5

    def signal(rows, n, spec, exact):
        x = torch.randn(rows, n, generator=gen, device=dev) * 2.0
        s = 0.5 if exact else float(scale_from_amax(0.8 * x.abs().max(),
                                                    spec))
        return x, s

    def held(kernel, what, got, want, dt, exact, stats):
        torch.cuda.synchronize()
        if stats:
            (got, gc, gr), (want, wc, wr) = got, want
            record(kernel, f"{what} counters", 0.0,
                   int(gc) == int(wc) and float(gr) == float(wr),
                   "count, ratio exact")
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        mx, ok = close(torch, got, want, rtol, exact)
        record(kernel, f"{what} counters={int(stats)}", mx, ok,
               "exact" if exact else f"rtol {rtol}")

    # -- paired stacked GEMV (#8): [G2, L, 256, O] at the decode's width
    cases = [(f"{k} G2{G2} O{O} L{N_LAYERS}", B, G2, O, N_LAYERS,
              torch.float32, False, False)
             for k, (G2, O) in PAIRED_SHAPES.items()]
    cases += [("wz G2192 O1536 L24 bf16", B, 192, 1536, N_LAYERS,
               torch.bfloat16, False, False),
              ("wo G2384 O768 L24 exact grid", B, 384, 768, N_LAYERS,
               torch.float32, True, False),
              ("ragged B3 G5 (phantom) O13 L3", 3, 3, 13, 3, torch.float32,
               False, True)]
    for what, rows, G2, O, L, dt, exact, odd in cases:
        n = G2 * 2 * group - (group if odd else 0)  # odd G: phantom pad
        w = weights((L, n, O), exact)
        x, scale = signal(rows, n, spec2, exact)
        stack = build_paired_stacked_tables(w, spec2, [scale] * L, group,
                                            dtype=dt)
        del w
        xp = F.pad(x, (0, group)) if odd else x
        for stats in (False, True):
            held("gemv_paired_stacked", what,
                 ops.pcilt_fused_gemv_paired_stacked(
                     xp, stack, L - 1, spec2, scale, group, with_stats=stats),
                 ops.gemv_paired_stacked_plain(
                     xp, stack, L - 1, spec2, scale, group, with_stats=stats),
                 dt, exact, stats)
        del stack

    # -- paired GEMV (#10): the parity probe's shapes, bf16, ragged
    for what, rows, n, O, dt, exact in [
            ("probe B4 64->128 exact grid", B, 64, 128, torch.float32, True),
            ("wz B4 768->1536", B, 768, 1536, torch.float32, False),
            ("wz B4 768->1536 bf16", B, 768, 1536, torch.bfloat16, False),
            ("ragged B3 G5 (phantom) O13", 3, 10, 13, torch.float32,
             False)]:
        w = weights((n, O), exact)
        x, scale = signal(rows, n, spec2, exact)
        tabs = build_paired_tables(w, spec2, scale, group).to(dt)
        xp = F.pad(x, (0, tabs.shape[0] * 2 * group - n))
        for stats in (False, True):
            held("gemv_paired", what,
                 ops.pcilt_fused_gemv_paired(xp, tabs, spec2, scale, group,
                                             with_stats=stats),
                 ops.gemv_paired_plain(xp, tabs, spec2, scale, group,
                                       with_stats=stats),
                 dt, exact, stats)

    # -- fused GEMV (#9): qwen3-0.6b's gate and down projections
    for what, rows, n, O, dt, exact in [
            (f"gate B4 {QWEN_D}->{QWEN_FF}", B, QWEN_D, QWEN_FF,
             torch.float32, False),
            (f"down B4 {QWEN_FF}->{QWEN_D}", B, QWEN_FF, QWEN_D,
             torch.float32, False),
            (f"gate B4 {QWEN_D}->{QWEN_FF} bf16", B, QWEN_D, QWEN_FF,
             torch.bfloat16, False),
            (f"gate B4 {QWEN_D}->{QWEN_FF} exact grid", B, QWEN_D, QWEN_FF,
             torch.float32, True),
            ("ragged B3 G7 O13", 3, 14, 13, torch.float32, False)]:
        w = weights((n, O), exact)
        x, scale = signal(rows, n, spec4, exact)
        tabs = build_grouped_tables(w, spec4, scale, group).to(dt)
        del w
        held("fused_gemv", what,
             ops.pcilt_fused_gemv(x, tabs, spec4, scale, group),
             ops.fused_gemv_plain(x, tabs, spec4, scale, group), dt, exact,
             False)
        del tabs

    # -- host-packed dwconv (#12): the single-layer signal's offsets
    for what, shape, V, dt in [
            (f"B4 T{CONV_T} C{CONV_C} V256", (B, CONV_T, CONV_C), 256,
             torch.float32),
            (f"B4 T{CONV_T} C{CONV_C} V256 bf16", (B, CONV_T, CONV_C), 256,
             torch.bfloat16),
            ("ragged B3 T9 C33 V16, offsets out of range", (3, 9, 33), 16,
             torch.float32)]:
        tabs = torch.randn(shape[-1], V, generator=gen, device=dev).to(dt)
        off = torch.randint(0, V, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        off[0, 0, 0], off[-1, -1, -1] = -1, V + 3
        got = ops.pcilt_dwconv1d(off, tabs)
        want = pcilt_dwconv1d_ref(off, tabs)
        torch.cuda.synchronize()
        mx, ok = close(torch, got, want, 0.0, exact=True)
        record("dwconv1d_host", what, mx, ok and float(got[0, 0, 0]) == 0.0,
               "exact")


def qwen_plans(torch, w):
    """Phase 10's SegmentPlans over the gate's ``QWEN_D`` positions (paper
    Fig. 7), from ``w [QWEN_D, QWEN_FF]``: ``perm`` pairs a seeded
    permutation of the positions; ``pruned`` pairs the 895 positions of
    largest row norm in ascending order, its last slot -1; ``reuse`` is the
    contiguous plan plus 64 segments that repeat the 128 positions of
    largest row norm."""
    from repro_torch.core.offsets import SegmentPlan

    cpu = torch.Generator().manual_seed(10)
    norms = w.norm(dim=1)

    def top(k):
        return torch.topk(norms, k).indices.sort().values.int().cpu()

    perm = torch.randperm(QWEN_D, generator=cpu).int()
    pruned = torch.cat([top(895), torch.tensor([-1], dtype=torch.int32)])
    reuse = torch.cat([torch.arange(QWEN_D, dtype=torch.int32), top(128)])
    return {name: SegmentPlan(t.numpy().reshape(-1, 2))
            for name, t in (("perm", perm), ("pruned", pruned),
                            ("reuse", reuse))}


def plan_offsets(torch, x, plan, spec, scale):
    """The offsets kernel 11 packs: ``x`` gathered by the plan, 0.0 in the
    unused slots, quantized and packed -> ``[B, G]``."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import quantize

    idx = plan.on(x.device).long().reshape(-1)
    xg = torch.where(idx >= 0, x[:, idx.clamp_min(0)], 0.0)
    return pack_offsets(quantize(xg, spec, scale), spec.bits, plan.group)


def check_plan_kernel(torch, ops, record, gen):
    """Kernel 11 (the plan GEMV) against its plain version: qwen3-0.6b's
    gate under phase 10's ``perm`` plan at B = 4 (float32 and bfloat16),
    an exact grid with a -1 slot and a reused position (bit-equal), and a
    ragged case (B 3, n 21, odd G 7, O 13, -1 slots, reused positions).
    Float32 within 1e-4 of max|plain| (sums over 512 rows), bfloat16
    within 1e-2 (one rounding of the float32 sum)."""
    import numpy as np

    from repro_torch.core.offsets import SegmentPlan
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import QuantSpec, scale_from_amax

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    w = torch.randn(QWEN_D, QWEN_FF, generator=gen, device=dev) \
        * QWEN_D ** -0.5
    perm = qwen_plans(torch, w)["perm"]
    rng = np.random.default_rng(11)
    ragged = rng.integers(0, 21, size=(7, 2)).astype(np.int32)
    ragged[1, 0] = ragged[5, 1] = -1
    exact = rng.permutation(64).astype(np.int32)
    exact[9] = -1  # position 9's slot unused ...
    exact = np.concatenate([exact, exact[:2]])  # ... and two reused
    cases = [("gate perm B4 1024->3072", perm, w, B, torch.float32, False),
             ("gate perm B4 1024->3072 bf16", perm, w, B, torch.bfloat16,
              False),
             ("exact grid B4 64->128, -1 slot, reuse",
              SegmentPlan(exact.reshape(-1, 2)),
              torch.randint(-3, 4, (64, 128), generator=gen,
                            device=dev).float(), B, torch.float32, True),
             ("ragged B3 n21 G7 O13, -1 slots, reuse", SegmentPlan(ragged),
              torch.randn(21, 13, generator=gen, device=dev), 3,
              torch.float32, False)]
    for what, plan, wc, rows, dt, ex in cases:
        n = wc.shape[0]
        if ex:
            x = torch.randint(-2, 2, (rows, n), generator=gen,
                              device=dev).float() * 0.5
            scale = 0.5
        else:
            x = torch.randn(rows, n, generator=gen, device=dev) * 2.0
            scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
        tabs = build_grouped_tables(wc, spec, scale, 2, plan=plan).to(dt)
        idx = plan.on(dev)
        got = ops.pcilt_fused_gemv_plan(x, tabs, idx, spec, scale, 2)
        want = ops.gemv_plan_plain(x, tabs, idx, spec, scale, 2)
        torch.cuda.synchronize()
        rtol = 1e-2 if dt == torch.bfloat16 else 1e-4
        mx, ok = close(torch, got, want, rtol, ex)
        record("gemv_plan", what, mx, ok, "exact" if ex else f"rtol {rtol}")
        del tabs


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
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

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
            k = timed(calls, GEMV_KERNEL)
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


def time_slice3_kernels(torch, ops, report, rows):
    """Phase 4 for the paired stacked GEMV (#8: the paired decode's wz and
    wo at B = 4, on segment-major [G2, 24, 256, O] stacks, with and without
    counters), the fused GEMV (#9: qwen3-0.6b's gate, 4-bit, group 2), the
    paired GEMV (#10: the parity probe at wz's width) and the host-packed
    dwconv (#12: the [4, 2048, 1792] single-layer signal, 2-bit, 4 taps):
    kernel, plain version at the same shape, library call and bound."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.pcilt import (build_grouped_tables,
                                        build_paired_stacked_tables,
                                        build_paired_tables)
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               quantize, scale_from_amax)
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    dev = torch.device("cuda")
    group, L = 2, N_LAYERS
    spec2, spec4 = QuantSpec(2, True), QuantSpec(4, True)
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = L2Flush(torch)

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

    def add(key, kernel, shape, k, plain, lib, nbytes, fetch_adds, launches,
            per):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fetch_adds / F32_OPS_PER_S * 1e3
        rows[key] = {"kernel": kernel, "shape": shape, "ms": k["ms"],
                     "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
                     "plain_ms": plain["ms"], "plain_warm_ms": plain["warm_ms"],
                     "plain_shape": "the kernel's", "library_ms": lib["ms"],
                     "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "bytes": nbytes, "fetch_adds": fetch_adds,
                     f"launches_per_{per}": launches}
        log(f"time  {kernel:19s} {key:26s} kernel {k['ms'] * 1e3:8.2f} us "
            f"(warm {k['warm_ms'] * 1e3:8.2f})  plain "
            f"{plain['ms'] * 1e3:9.2f} us  library {lib['ms'] * 1e3:8.2f} us"
            f"  bound {max(b_ms, o_ms) * 1e3:7.2f} us "
            f"({rows[key]['bound_by']})  x{launches}/{per}")

    def gemv_bytes(x, off, O, out_rows):
        """Distinct table rows this run's offsets fetch, x read once, the
        output written once (float32)."""
        uniq = sum(len(torch.unique(off[:, g])) for g in range(off.shape[1]))
        return uniq * O * 4 + x.numel() * 4 + out_rows * O * 4

    # -- #8 on the paired decode's stacks; launches per step as the engine
    #    makes them (wz and wo share their shapes with wx and the counters)
    per_step = {("wz", False): 24, ("wz", True): 24, ("wo", True): 24,
                ("wo", False): 0}
    for key, (G2, O) in PAIRED_SHAPES.items():
        n = G2 * 2 * group
        w = torch.randn(L, n, O, generator=gen, device=dev) * n ** -0.5
        x = torch.randn(B, n, generator=gen, device=dev)
        scale = float(scale_from_amax(0.8 * x.abs().max(), spec2))
        stack = build_paired_stacked_tables(w, spec2, [scale] * L, group)
        off = pack_offsets(quantize(x, spec2, scale), spec2.bits, 2 * group)
        nbytes = gemv_bytes(x, off, O, B)
        xq = fake_quant(x, spec2, scale)
        lays = range(min(8, L))
        lib = timed([lambda l=l: torch.matmul(xq, w[l]) for l in lays] * 4)
        for stats in (False, True):
            calls = [lambda l=l: ops.pcilt_fused_gemv_paired_stacked(
                x, stack, l, spec2, scale, group, with_stats=stats)
                for l in lays] * 4
            plain = [lambda l=l: ops.gemv_paired_stacked_plain(
                x, stack, l, spec2, scale, group, with_stats=stats)
                for l in lays] * 2
            add(f"paired {key}{' counters' if stats else ''}",
                "gemv_paired_stacked", [G2, L, 256, O], timed(calls,
                                                              GEMV_KERNEL),
                timed(plain), lib, nbytes, B * G2 * O,
                per_step[(key, stats)], "step")
        del stack, w

    # -- #9: qwen3-0.6b's gate projection (1.61 GB of float32 tables)
    n, O = QWEN_D, QWEN_FF
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec4))
    tabs = build_grouped_tables(w, spec4, scale, group)
    nbytes = statistics.mean(gemv_bytes(
        x, pack_offsets(quantize(x, spec4, scale), 4, group), O, B)
        for x in xs)
    xqs = [fake_quant(x, spec4, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, w) for q in xqs] * 4)
    k = timed([lambda x=x: ops.pcilt_fused_gemv(x, tabs, spec4, scale, group)
               for x in xs] * 4, GEMV_KERNEL)
    p = timed([lambda x=x: ops.fused_gemv_plain(x, tabs, spec4, scale, group)
               for x in xs] * 2)
    add("fused_gemv gate", "fused_gemv", [n // group, 256, O], k, p, lib,
        nbytes, B * (n // group) * O, 1, "projection")
    del tabs, w

    # -- #10: the parity probe at wz's width, [4, 768] -> 1536, 2-bit
    n, O = 768, 1536
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec2))
    tabs = build_paired_tables(w, spec2, scale, group)
    nbytes = statistics.mean(gemv_bytes(
        x, pack_offsets(quantize(x, spec2, scale), 2, 2 * group), O, B)
        for x in xs)
    xqs = [fake_quant(x, spec2, scale) for x in xs]
    lib = timed([lambda q=q: torch.matmul(q, w) for q in xqs] * 4)
    k = timed([lambda x=x: ops.pcilt_fused_gemv_paired(
        x, tabs, spec2, scale, group) for x in xs] * 4, GEMV_KERNEL)
    p = timed([lambda x=x: ops.gemv_paired_plain(x, tabs, spec2, scale,
                                                 group) for x in xs] * 2)
    add("gemv_paired wz", "gemv_paired", [n // (2 * group), 256, O], k, p,
        lib, nbytes, B * (n // (2 * group)) * O, 1, "probe")
    del tabs, w

    # -- #12: the single-layer signal's offsets, [4, 2048, 1792], V = 256
    V = 1 << (spec2.bits * CONV_K)
    tabs = torch.randn(CONV_C, V, generator=gen, device=dev)
    x = torch.randn(B, CONV_T + CONV_K - 1, CONV_C, generator=gen, device=dev)
    codes = quantize(x, spec2, float(scale_from_amax(x.abs().max(), spec2)))
    codes = codes.int()
    off = sum(codes[:, j:j + CONV_T] << (spec2.bits * j)
              for j in range(CONV_K)).contiguous()
    idx = (torch.arange(CONV_C, device=dev) * V + off.long()).contiguous()
    cells = len(torch.unique(idx))
    nbytes = cells * 4 + off.numel() * 4 + off.numel() * 4
    lib = timed([lambda: torch.take(tabs, idx)] * 4)
    k = timed([lambda: ops.pcilt_dwconv1d(off, tabs)] * 4, DWCONV_HOST_KERNEL)
    p = timed([lambda: pcilt_dwconv1d_ref(off, tabs)] * 2)
    add("dwconv1d_host signal", "dwconv1d_host", [B, CONV_T, CONV_C, V], k, p,
        lib, nbytes, 0, 1, "layer call")
    del tabs, x, off, idx, flush


def time_plan_kernel(torch, ops, report, rows):
    """Phase 4 for kernel 11, the plan GEMV, at qwen3-0.6b's gate under
    phase 10's ``perm`` plan (G 512, 1.61 GB of float32 tables, B = 4, x
    rotating over 4 inputs): kernel, plain version at the same shape,
    ``torch.matmul`` of the quantized, gathered input by the gathered
    weights, and the bound (distinct rows fetched, x and the plan read
    once, the output written once)."""
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               scale_from_amax)

    dev = torch.device("cuda")
    spec = QuantSpec(4, True)
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = L2Flush(torch)
    n, O = QWEN_D, QWEN_FF
    w = torch.randn(n, O, generator=gen, device=dev) * n ** -0.5
    plan = qwen_plans(torch, w)["perm"]
    idx = plan.on(dev)
    xs = [torch.randn(B, n, generator=gen, device=dev) for _ in range(4)]
    scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec))
    tabs = build_grouped_tables(w, spec, scale, 2, plan=plan)
    G = plan.n_segments
    uniq = statistics.mean(
        sum(len(torch.unique(off[:, g])) for g in range(G))
        for off in (plan_offsets(torch, x, plan, spec, scale) for x in xs))
    nbytes = uniq * O * 4 + B * n * 4 + idx.numel() * 4 + B * O * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = B * G * O / F32_OPS_PER_S * 1e3
    wg = plan.gather_weights(w).reshape(-1, O)
    gather = idx.long().reshape(-1)
    xqs = [fake_quant(x, spec, scale)[:, gather] for x in xs]

    def timed(calls, kernel=None):
        return time_calls(torch, calls, flush, kernel,
                          retries=report["profile_retries"])

    lib = timed([lambda q=q: torch.matmul(q, wg) for q in xqs] * 4)
    k = timed([lambda x=x: ops.pcilt_fused_gemv_plan(x, tabs, idx, spec,
                                                     scale, 2)
               for x in xs] * 4, GEMV_KERNEL)
    p = timed([lambda x=x: ops.gemv_plan_plain(x, tabs, idx, spec, scale, 2)
               for x in xs] * 2)
    rows["gemv_plan perm"] = {
        "kernel": "gemv_plan", "shape": [G, 256, O], "ms": k["ms"],
        "warm_ms": k["warm_ms"], "events_ms": k["events_ms"],
        "plain_ms": p["ms"], "plain_warm_ms": p["warm_ms"],
        "plain_shape": "the kernel's", "library_ms": lib["ms"],
        "library_warm_ms": lib["warm_ms"],
        "library_call": LIB_NOTE["gemv_plan"], "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bytes": nbytes, "fetch_adds": B * G * O,
        "launches_per_projection": 1}
    log(f"time  {'gemv_plan':19s} {'gemv_plan perm':26s} kernel "
        f"{k['ms'] * 1e3:8.2f} us (warm {k['warm_ms'] * 1e3:8.2f})  plain "
        f"{p['ms'] * 1e3:9.2f} us  library {lib['ms'] * 1e3:8.2f} us  bound "
        f"{max(b_ms, o_ms) * 1e3:7.2f} us ({rows['gemv_plan perm']['bound_by']})"
        f"  x1/projection")
    del tabs, w, wg, flush


def paper_cnn_setup(torch):
    """The paper CNN at its published widths with seeded weights, per-layer
    scales from a dense forward over one seeded 1024x768 calibration image,
    and one seeded 1024x768 test image (values uniform in [0, 2))."""
    import numpy as np

    from repro_torch.configs.paper_cnn import config

    model = config()
    params = model.init_params(seed=0)
    rng = np.random.default_rng(12)

    def image():
        return torch.from_numpy(rng.uniform(0.0, 2.0, (1, *FULL_HW, 1))
                                .astype(np.float32)).cuda()

    with torch.no_grad():
        scales = model.calibrate(params, image())
    return model, params, scales, image()


def host_offsets(torch, xp, spec, scale, k, G, band=32):
    """The host-packed path's offsets ``[1, Ho, Wo, G]`` int32 of a padded
    image (group 1, stride 1), built ``band`` output rows at a time (the
    whole conv4 patch would take ~16 GB in float32 plus its packing
    temporaries)."""
    from repro_torch.core.lut_layers import conv_offsets

    Ho, Wo = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    off = torch.empty((1, Ho, Wo, G), dtype=torch.int32, device=xp.device)
    for y in range(0, Ho, band):
        y1 = min(Ho, y + band)
        off[:, y:y1] = conv_offsets(xp[:, y:y1 - 1 + k], spec, scale, 1, k,
                                    k, 1, "VALID")
    return off


def time_conv_kernels(torch, ops, report, rows):
    """Phase 4 for the conv kernels: each layer of the paper CNN at B = 1,
    1024x768, on its real input (the dense fake-quant chain of the seeded
    network): the wrapper's device time (padded input, so the call is the
    kernels alone: for the fused and shared conv the staged design's code
    pre-pass and fetch, two launches, summed), the kept design's forced
    beside it (``direct_ms``), the plain version's on the top-left 64x48
    crop (labelled ``plain_shape``), one library call, the bound and, for
    the conv kernels, the fetch floor: the fetch-adds' 4-byte cells over
    the SMs' shared-memory rate, 128 B a clock each at ``clocks.max.sm``."""
    import torch.nn.functional as F

    from repro_torch.core.lut_layers import conv_offsets, flatten_filters
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.quantization import fake_quant
    from repro_torch.core.serving import convert_conv_kernel
    from repro_torch.kernels.ref import pcilt_conv2d_ref, pcilt_gemv_ref
    from repro_torch.models.cnn import dm_conv2d

    model, params, scales, x = paper_cnn_setup(torch)
    spec, k = model.act_spec, model.k
    flush = L2Flush(torch)
    h, small = x, x[:, :SMALL_HW[0], :SMALL_HW[1]]

    def timed(calls, kernel=None, per_call=1):
        return time_calls(torch, calls, flush, kernel, reps=1, warmup=1,
                          retries=report["profile_retries"],
                          launches_per_call=per_call)

    def add(kernel, i, shape, kt, plain, lib, nbytes, ops_, direct=None):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops_ / F32_OPS_PER_S * 1e3
        key = f"{kernel} conv{i}"
        rows[key] = {"kernel": kernel, "shape": shape, "ms": kt["ms"],
                     "warm_ms": kt["warm_ms"], "events_ms": kt["events_ms"],
                     "plain_ms": plain["ms"],
                     "plain_shape": f"B1 {SMALL_HW[1]}x{SMALL_HW[0]} crop",
                     "library_ms": lib["ms"],
                     "library_warm_ms": lib["warm_ms"],
                     "library_call": LIB_NOTE[kernel],
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms > o_ms else "operations",
                     "fetch_adds": ops_, "bytes": nbytes,
                     "launches_per_forward": 1}
        extra = ""
        if direct is not None:
            floor = ops_ * 4 / (report["sm_count"] * SMEM_BYTES_PER_CLOCK
                                * report["sm_clock_max_mhz"] * 1e6) * 1e3
            rows[key].update(variant="staged", direct_ms=direct["ms"],
                             direct_warm_ms=direct["warm_ms"],
                             fetch_floor_ms=floor)
            extra = (f"  kept kernel {direct['ms']:10.3f} ms  fetch floor "
                     f"{floor:8.3f} ms")
        log(f"time  {kernel:13s} conv{i} {shape}  kernel "
            f"{kt['ms']:10.3f} ms (warm {kt['warm_ms']:10.3f})  plain "
            f"{plain['ms']:8.3f} ms at {SMALL_HW[1]}x{SMALL_HW[0]}  library "
            f"{lib['ms']:8.3f} ms  bound {max(b_ms, o_ms):8.3f} ms "
            f"({rows[key]['bound_by']}){extra}")

    with torch.no_grad():
        for i, (C, O) in enumerate(conv_layers(model)):
            name = f"conv{i}"
            w, s = params[name], scales[name]
            tabs = build_grouped_tables(flatten_filters(w, 1), spec, s, 1)
            layer = convert_conv_kernel(w, spec, s, 1, weight_bits=4,
                                        shared=True)
            pool, wq = layer.shared, layer.filters
            xp, xps = padded(h, k, 1), padded(small, k, 1)
            P, (G, V, _) = h.shape[1] * h.shape[2], tabs.shape
            shape = f"B1 {FULL_HW[1]}x{FULL_HW[0]} C{C} G{G} V{V} O{O}"
            fetch_adds = P * G * O
            out_bytes = P * O * 4
            xq = fake_quant(xp, spec, s).permute(0, 3, 1, 2).contiguous()
            w4 = w.permute(3, 2, 0, 1).contiguous()
            wq4 = wq.permute(3, 2, 0, 1).contiguous()
            require(ops.conv_variant(V, tabs.element_size()) == "staged",
                    f"{name}: the paper CNN's V = {V} is not staged")
            lib = timed([lambda: F.conv2d(xq, w4)])
            kt = timed([lambda: ops.pcilt_fused_conv2d(
                xp, tabs, spec, s, 1, k, k, padding="VALID")],
                STAGED_KERNELS, per_call=2)
            direct = timed([lambda: ops._fused_conv2d(
                xp, tabs, spec, s, 1, k, k, padding="VALID",
                variant="direct")], DIRECT_KERNEL)
            plain = timed([lambda: ops.fused_conv2d_plain(
                xps, tabs, spec, s, 1, k, k, 1)])
            add("fused_conv2d", i, shape, kt, plain, lib,
                xp.numel() * 4 + tabs.numel() * 4 + out_bytes, fetch_adds,
                direct)
            lib = timed([lambda: F.conv2d(xq, wq4)])
            kt = timed([lambda: ops.pcilt_shared_conv2d(
                xp, pool.pool, pool.seg_idx, spec, s, 1, k, k,
                padding="VALID")], STAGED_KERNELS, per_call=2)
            direct = timed([lambda: ops._shared_conv2d(
                xp, pool.pool, pool.seg_idx, spec, s, 1, k, k,
                padding="VALID", variant="direct")], DIRECT_KERNEL)
            plain = timed([lambda: ops.shared_conv2d_plain(
                xps, pool.pool, pool.seg_idx, spec, s, 1, k, k, 1)])
            add("shared_conv2d", i, shape + f" X{pool.pool.shape[0]}", kt,
                plain, lib, xp.numel() * 4 + pool.pool_bytes() + out_bytes,
                fetch_adds, direct)
            del xq, pool, layer
            # the host-packed kernels on the layer's offsets; their plain
            # versions (the ref fetch-sums) on the crop's offsets; the
            # library call on int64 indices (its 2-D form counts bags in
            # the index dtype: more than 2**31 of them at conv3 and conv4)
            off = host_offsets(torch, xp, spec, s, k, G)
            offs = conv_offsets(xps, spec, s, 1, k, k, 1, "VALID")
            host = {"gemv_host": (ops.pcilt_gemv, pcilt_gemv_ref,
                                  off.view(-1, G), offs.view(-1, G))}
            if i == len(model.channels) - 1:  # the satellite, at conv4
                host["conv2d_host"] = (ops.pcilt_conv2d, pcilt_conv2d_ref,
                                       off, offs)
            kts = {n_: timed([lambda f=v[0], o=v[2]: f(o, tabs)],
                             "gemv_host_kernel") for n_, v in host.items()}
            plains = {n_: timed([lambda f=v[1], o=v[3]: f(o, tabs)])
                      for n_, v in host.items()}
            off_bytes = off.numel() * 4
            idx = off.view(-1, G).long()
            del off, host
            idx += torch.arange(G, device=idx.device) * V
            tab2d = tabs.view(G * V, O)
            for name_ in kts:  # one library call timed for each row
                lib = timed([lambda: F.embedding_bag(idx, tab2d, mode="sum")])
                add(name_, i, shape, kts[name_], plains[name_], lib,
                    off_bytes + tabs.numel() * 4 + out_bytes, fetch_adds)
            del idx, offs, tab2d
            h = torch.relu(dm_conv2d(h, w, spec, s))
            small = h[:, :SMALL_HW[0], :SMALL_HW[1]]
            del tabs, xp
            torch.cuda.empty_cache()
    del flush


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
    head = eng.pdecode.pcilt["head"]
    head_bytes = head["pool"].numel() * head["pool"].element_size()
    log(f"engine: set-up {setup_s:.1f} s; conversion "
        + ", ".join(f"{k} {v:.1f}" for k, v in conv.items())
        + f"; table bytes (conv + projection stacks) "
        f"{eng.pdecode.table_bytes() / 2**30:.2f} GiB")
    log(f"head pool bytes: {head_bytes} ({head_bytes / 2**30:.2f} GiB, "
        f"{head['pool'].shape[0]} segments)")
    reqs = make_requests(cfg, 4, 8, seed=0)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
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
                       "head_pool_bytes": head_bytes,
                       "outputs": [r.out for r in reqs]}
    oracle_check(torch, ops, eng, report)
    return launches


def oracle_check(torch, ops, eng, report, key="oracle"):
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
    report[key] = {"max_abs_err": err, "tol": tol,
                   "argmax_equal": int(agree.sum()),
                   "near_ties": int((~decided).sum())}
    require(bool(torch.isfinite(got).all()), "non-finite logits")
    require(err <= tol, "decode step disagrees with the dense oracle")
    require(bool((agree | (~decided & tie_ok)).all()),
            "greedy token differs from the dense oracle's")


# ----------------------------------------------------------------------------
# phase 6: the paper CNN
# ----------------------------------------------------------------------------


def _logits_check(torch, what, got, want, report_key, report):
    """End-to-end logits against the direct-multiplication oracle: allclose
    at rtol = atol = 1e-3 (``tests/test_system.py``'s tolerance), argmax
    equal."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3))
    agree = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"oracle {what}: max |logit - dm| {err:.3e} (max |logit| "
        f"{float(want.abs().max()):.3f}, rtol = atol = 1e-3), argmax "
        f"{'equal' if agree else 'DIFFERS'}")
    report[report_key] = {"max_abs_err": err, "allclose": ok,
                          "argmax_equal": agree, "logits": got.tolist(),
                          "oracle": want.tolist()}
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    require(ok, f"{what}: logits disagree with direct multiplication")
    require(agree, f"{what}: argmax differs from direct multiplication")


def _run_layers(torch, layers, params, x, conv):
    """The CNN's forward over per-layer callables ``conv(layer, h)``: conv,
    ReLU, global mean pool, head matmul."""
    h = x
    for layer in layers:
        h = torch.relu(conv(layer, h))
    return torch.matmul(h.float().mean(dim=(1, 2)), params["head"])


def paper_cnn(torch, ops, report):
    """The paper CNN at its published widths on one 1024x768 image, through
    ``forward(mode="fused")``, the extension-3 network of
    ``convert_conv_kernel(shared=True, weight_bits=4)`` layers, and
    ``forward(mode="kernel")`` on a 256x192 image; each path's launches
    are counted from 0 and must be 5.  Returns the launch counts."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.serving import convert_conv_kernel
    from repro_torch.models.cnn import dm_conv2d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, params, scales, x = paper_cnn_setup(torch)
    spec, k, L = model.act_spec, model.k, len(model.channels)
    out = {"scales": scales}
    launches = {}

    def counted(kernel, fn):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: c for n, c in ops.LAUNCHES.items() if c}
        log(f"  launches: {got}")
        require(got == {kernel: L},
                f"{kernel} path did not run through its kernel {L} times: "
                f"{got}")
        launches[kernel] = L
        return res, secs

    def variant_of(fn):
        """``fn()`` and the conv design that served it."""
        seen = dict(ops.CONV_VARIANT_LAUNCHES)
        res = fn()
        ran = [v for v, c in ops.CONV_VARIANT_LAUNCHES.items()
               if c != seen[v]]
        require(len(ran) == 1, f"one conv call ran {ran}")
        return res, ran[0]

    with torch.no_grad():
        t0 = time.perf_counter()
        tables = model.build_tables(params, scales)
        torch.cuda.synchronize()
        tbytes = sum(t.numel() * t.element_size() for t in tables.values())
        out["build_s"], out["table_bytes"] = time.perf_counter() - t0, tbytes
        log(f"paper CNN {model.channels}, {k}x{k}, INT{spec.bits}: tables "
            f"{tbytes / 2**30:.2f} GiB built in {out['build_s']:.2f} s; "
            + ", ".join(f"{n} {t.numel() / 1e6:.1f} M cells"
                        for n, t in tables.items()))
        require(tbytes == 688_960_000 * 4, "table bytes differ from the "
                "published widths' 688,960,000 float32 cells")

        # extrapolate from a 256x192 forward before the full-size one
        xs = x[:, :KERNEL_HW[0], :KERNEL_HW[1]].contiguous()
        model.forward(params, xs, mode="fused", scales=scales, tables=tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, xs, mode="fused", scales=scales, tables=tables)
        torch.cuda.synchronize()
        small_s = time.perf_counter() - t0
        est = small_s * FULL_HW[0] * FULL_HW[1] / (KERNEL_HW[0]
                                                   * KERNEL_HW[1])
        log(f"fused forward {KERNEL_HW[1]}x{KERNEL_HW[0]}: {small_s:.3f} s, "
            f"so ~{est:.1f} s at {FULL_HW[1]}x{FULL_HW[0]}")
        out["fused_small_s"], out["fused_est_s"] = small_s, est
        require(est < 60, f"a full-size forward would take ~{est:.0f} s")

        log(f"fused forward, {FULL_HW[1]}x{FULL_HW[0]}:")
        logits, secs = counted("fused_conv2d", lambda: model.forward(
            params, x, mode="fused", scales=scales, tables=tables))
        out["fused"] = {"forward_s": secs, "images_per_s": 1 / secs}
        log(f"  forward {secs * 1e3:.1f} ms, {1 / secs:.3f} images/s")

        # per layer on the same input: the kernel's device time, its output
        # against F.conv2d on the fake-quantized padded input, and the codes
        # that flipped between the PCILT chain and the DM chain
        hp = hd = x
        per_layer = []
        for i in range(L):
            name = f"conv{i}"
            w, s = params[name], scales[name]
            flips = int((quantize(hp, spec, s) != quantize(hd, spec, s)).sum())
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            got, variant = variant_of(lambda: ops.pcilt_fused_conv2d(
                hp, tables[name], spec, s, 1, k, k))
            ev1.record()
            ev1.synchronize()
            want = dm_conv2d(hp, w, spec, s)
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max())
            per_layer.append({"layer": name, "ms": ev0.elapsed_time(ev1),
                              "variant": variant,
                              "max_abs_err": err, "tol": tol,
                              "codes_flipped": flips,
                              "codes": hp.numel()})
            log(f"  {name}: {per_layer[-1]['ms']:9.3f} ms ({variant}); "
                f"|conv - dm| "
                f"{err:.3e} (tol {tol:.3e} = 1e-4 max|dm|: float32 sums "
                f"of up to 5000 products in another order); input codes "
                f"flipped vs the DM chain {flips} of {hp.numel()}")
            require(err <= tol, f"{name}: PCILT conv disagrees with F.conv2d")
            hp, hd = torch.relu(got), torch.relu(dm_conv2d(hd, w, spec, s))
        out["fused"]["layers"] = per_layer
        dm = model.forward(params, x, mode="dm", scales=scales)
        _logits_check(torch, f"fused {FULL_HW[1]}x{FULL_HW[0]}", logits, dm,
                      "fused_oracle", out)

        log("extension-3 network (convert_conv_kernel(shared=True, "
            f"weight_bits=4) per layer), {FULL_HW[1]}x{FULL_HW[0]}:")
        convs = [convert_conv_kernel(params[f"conv{i}"], spec,
                                     scales[f"conv{i}"], 1, weight_bits=4,
                                     shared=True) for i in range(L)]
        out["shared"] = {"pools": [
            {"X": c.shared.pool_cardinality, "G": c.n_segments,
             "pool_bytes": c.table_bytes()} for c in convs]}
        for i, p in enumerate(out["shared"]["pools"]):
            log(f"  conv{i}: X {p['X']} of G {p['G']} segments, pool "
                f"{p['pool_bytes'] / 2**20:.1f} MiB")
        served = []

        def shared_layer(c, h):
            res, variant = variant_of(lambda: c(h, path="shared"))
            served.append(variant)
            return res

        logits, secs = counted("shared_conv2d", lambda: _run_layers(
            torch, convs, params, x, shared_layer))
        out["shared"].update(forward_s=secs, images_per_s=1 / secs,
                             variants=served)
        log(f"  forward {secs * 1e3:.1f} ms, {1 / secs:.3f} images/s; "
            f"designs per layer {served}")
        dm = _run_layers(torch, convs, params, x,
                         lambda c, h: dm_conv2d(h, c.filters, spec, c.scale))
        _logits_check(torch, f"shared {FULL_HW[1]}x{FULL_HW[0]}", logits, dm,
                      "shared_oracle", out)
        del convs

        log(f"host-packed forward (mode='kernel'), {KERNEL_HW[1]}x"
            f"{KERNEL_HW[0]} (at full size its patches and offsets would "
            f"take ~31 GB):")
        logits, secs = counted("gemv_host", lambda: model.forward(
            params, xs, mode="kernel", scales=scales, tables=tables))
        out["kernel"] = {"forward_s": secs, "image": list(KERNEL_HW)}
        log(f"  forward {secs * 1e3:.1f} ms")
        dm = model.forward(params, xs, mode="dm", scales=scales)
        _logits_check(torch, f"kernel {KERNEL_HW[1]}x{KERNEL_HW[0]}", logits,
                      dm, "kernel_oracle", out)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"paper CNN peak memory allocated {out['peak_bytes'] / 2**30:.2f} GiB")
    report["paper_cnn"] = out
    return launches


# ----------------------------------------------------------------------------
# phase 7: paired (TL1) decode at full width
# ----------------------------------------------------------------------------


def _step_times(torch, ops, step, reps=3):
    """Median host seconds of ``reps`` synchronised calls of ``step`` (after
    one warm call), the launches of one call, and the device time of one
    call (the sum of its kernels' profiler device time)."""
    step()
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ops.reset_launches()
    step()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    dev_us = sum(t for _, t in _profile(torch, step).values())
    return statistics.median(secs), launches, dev_us / 1e6


def serve_paired(torch, ops, report):
    """Paired decode at full width and depth: mamba2-130m,
    ``PCILTConfig(act_bits=2, group=2)``, float32 tables, shared-pool head,
    converted by ``convert_mamba_decode(paired=True)`` and served by
    ``Engine(pcilt_bundle=...)`` (4 slots, 4 requests of 8 new tokens,
    sentinel counters on); then the median of three decode steps at B = 4,
    dense, unpaired (kernel 1) and paired (kernel 8), and one step against
    the dense fake-quant oracle.  Returns the path's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PCILTConfig
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.launch.serve import Engine, make_requests
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=2, group=2),
                              dtype=torch.float32)
    out = {"config": "mamba2-130m, act_bits 2, group 2, float32, paired, "
                     "head shared"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, "cuda")
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    conv = {}
    t0 = time.perf_counter()
    dec = convert_mamba_decode(model, params, calib, paired=True,
                               head="shared", timings=conv, device="cuda")
    conv["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = Engine(cfg, slots=B, pcilt=True, params=params,
                 pcilt_bundle=dec.pcilt, device="cuda")
    torch.cuda.synchronize()
    conv["engine_load_verify_s"] = time.perf_counter() - t0
    proj = dec.pcilt["proj"]
    head = dec.pcilt["head"]
    tbytes = dec.table_bytes()
    head_bytes = head["pool"].numel() * head["pool"].element_size()
    shapes = {k: list(t.shape) for k, t in proj["tables"].items()}
    log("paired conversion: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in conv.items()))
    log(f"paired tables (conv + projection stacks): {tbytes / 2**30:.2f} GiB;"
        f" segment-major stacks {shapes}")
    log(f"head pool bytes: {head_bytes} ({head_bytes / 2**30:.2f} GiB, "
        f"{head['pool'].shape[0]} segments)")
    require(proj["paired"] and all(s[1] == cfg.n_layers and s[2] == 256
                                   for s in shapes.values()),
            f"not segment-major paired stacks: {shapes}")

    reqs = make_requests(cfg, 4, 8, seed=0)
    ops.reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    steps = stats["decode_ticks"] + stats["prefill_ticks"]
    per_step = {k: v / steps for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(eng.step_seconds)
    log(f"paired: served {stats['served']}/{len(reqs)} requests, {steps} "
        f"steps in {stats['wall_s']:.2f} s; median step {med * 1e3:.2f} ms "
        f"({B / med:.1f} tokens/s over {B} slots); peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    log("paired launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items()))
    for r in reqs:
        log(f"  req {r.rid}: prompt {len(r.prompt)} -> {r.out}")
    require(stats["served"] == len(reqs), "not every request was served")
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
                for r in reqs), "generated tokens out of range")
    require(per_step == {"gemv_paired_stacked": 144, "dwconv1d": 24,
                         "shared_gemv": 1},
            f"paired path did not run through the kernels: {per_step}")
    require(stats["table_bytes"] == tbytes, "engine and bundle table bytes "
            "differ")
    out.update(convert=conv, table_bytes=tbytes, head_pool_bytes=head_bytes,
               stack_shapes=shapes, peak_bytes=peak, steps=steps,
               median_step_s=med, step_seconds=eng.step_seconds,
               launches=launches, launches_per_step=per_step,
               saturation=stats.get("saturation"),
               outputs=[r.out for r in reqs])
    report["serve_paired"] = out
    oracle_check(torch, ops, eng, report, "paired_oracle")

    # the step at B = 4: dense, unpaired (kernel 1) and paired (kernel 8)
    unpaired = convert_mamba_decode(model, params, calib, head="shared",
                                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    cache = {"layers": {k: torch.randn(t.shape, generator=gen,
                                       device="cuda") * 0.1
                        for k, t in eng.cache["layers"].items()}}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda")
    variants = {"dense": None, "unpaired": unpaired.pcilt,
                "paired": dec.pcilt}
    want = {"dense": {}, "unpaired": {"gemv_stacked": 144, "dwconv1d": 24,
                                      "shared_gemv": 1},
            "paired": {"gemv_paired_stacked": 144, "dwconv1d": 24,
                       "shared_gemv": 1}}
    cmp = {}
    with torch.no_grad():
        for name, pc in variants.items():
            s, ln, dev_s = _step_times(torch, ops, lambda pc=pc: model
                                       .decode_step(params, cache, tok,
                                                    pcilt=pc))
            cmp[name] = {"median_step_s": s, "launches": ln,
                         "device_s": dev_s, "device_share": dev_s / s}
            log(f"step B{B} {name:8s}: median {s * 1e3:8.2f} ms, device "
                f"time {dev_s * 1e3:7.2f} ms ({100 * dev_s / s:5.1f}% "
                f"busy), launches {ln}")
            require(ln == want[name], f"{name} step launches {ln}")
    out["step_compare"] = cmp
    unpaired_bytes = unpaired.table_bytes()
    out["unpaired_table_bytes"] = unpaired_bytes
    del unpaired, variants, eng, dec
    return launches


# ----------------------------------------------------------------------------
# phase 8: exact-grid paired parity
# ----------------------------------------------------------------------------


def paired_parity(torch, ops, report):
    """``decode_e2e_pr8``'s probe (``benchmarks/run.py``): integer weights,
    scale 0.5, 2-bit symmetric codes; ``pcilt_linear(path="fused")`` on
    ``[G, V, O]`` (kernel 9) and ``pcilt_linear(paired=True,
    path="fused")`` on ``[G2, V2, O]`` (kernel 10) must be bit-equal, at
    the probe's ``[4, 64] -> 128`` and at wz's ``[4, 768] -> 1536``.
    Returns the launches."""
    from repro_torch.core.lut_layers import pcilt_linear
    from repro_torch.core.pcilt import build_grouped_tables, build_paired_tables
    from repro_torch.core.quantization import QuantSpec

    spec = QuantSpec(2, True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for n, O in [(64, 128), (768, 1536)]:
        kw = torch.randint(-2, 3, (n, O), generator=gen,
                           device="cuda").float()
        xs = torch.randint(-2, 2, (B, n), generator=gen,
                           device="cuda").float()
        cases.append((n, O, xs, build_grouped_tables(kw, spec, 0.5, 2),
                      build_paired_tables(kw, spec, 0.5, 2)))
    ops.reset_launches()
    outs = [(pcilt_linear(xs, tu, spec, 0.5, 2, path="fused"),
             pcilt_linear(xs, tp, spec, 0.5, 2, path="fused", paired=True))
            for _, _, xs, tu, tp in cases]
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    res = []
    for (n, O, xs, tu, tp), (ou, op) in zip(cases, outs):
        diff = float((ou - op).abs().max())
        plain = ops.fused_gemv_plain(xs, tu, spec, 0.5, 2)
        res.append({"shape": f"[{B}, {n}] -> {O}", "max_abs_diff": diff,
                    "equal_plain": bool(torch.equal(ou, plain))})
        log(f"paired parity [{B}, {n}] -> {O}: max |paired - unpaired| "
            f"{diff} (bit-exact contract: 0); unpaired equals its plain "
            f"version: {res[-1]['equal_plain']}")
        require(torch.equal(ou, op), f"paired parity broken at {n}->{O}")
        require(res[-1]["equal_plain"], "fused GEMV differs from its plain "
                "version on the exact grid")
    log(f"  launches: {launches}")
    require(launches == {"fused_gemv": 2, "gemv_paired": 2},
            f"parity probe did not run through kernels 9 and 10: {launches}")
    report["paired_parity"] = {"cases": res, "launches": launches}
    return launches


# ----------------------------------------------------------------------------
# phase 9: the single-layer API at full published widths
# ----------------------------------------------------------------------------


def single_layers(torch, ops, report):
    """``convert_kernel`` -> ``PCILTLinear`` on qwen3-0.6b's MLP (d 1024,
    d_ff 3072, 4-bit activations, group 2: 1.61 GB of float32 tables per
    projection) through ``path="fused"`` at B = 4, each projection against
    the dense product on the quantized grid; ``convert_dwconv`` ->
    ``PCILTDwConv1d`` on mamba2-130m's conv frontend (C 1792, k 4, 2-bit)
    on a seeded [4, 2048, 1792] signal through ``path="kernel"``, against
    ``path="fused"`` (equal from t >= k - 1) and against its plain
    version.  Returns the launches."""
    import torch.nn.functional as F

    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import (QuantSpec, calibrate,
                                               fake_quant, quantize)
    from repro_torch.core.serving import (convert_dwconv, convert_kernel,
                                          mlp_table_bytes)
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    spec4, spec2 = QuantSpec(4, True), QuantSpec(2, True)
    out = {}
    with torch.no_grad():
        ws = {"gate": torch.randn(QWEN_D, QWEN_FF, generator=gen,
                                  device="cuda") * QWEN_D ** -0.5,
              "up": torch.randn(QWEN_D, QWEN_FF, generator=gen,
                                device="cuda") * QWEN_D ** -0.5,
              "down": torch.randn(QWEN_FF, QWEN_D, generator=gen,
                                  device="cuda") * QWEN_FF ** -0.5}
        x = torch.randn(B, QWEN_D, generator=gen, device="cuda")
        t0 = time.perf_counter()
        s_in = float(calibrate(x, spec4))
        gate = convert_kernel(ws["gate"], spec4, s_in, 2)
        up = convert_kernel(ws["up"], spec4, s_in, 2)
        torch.cuda.synchronize()
        # the down projection's input comes from the fused gate and up
        ops.reset_launches()
        g, u = gate(x, path="fused"), up(x, path="fused")
        h = F.silu(g) * u
        s_h = float(calibrate(h, spec4))
        down = convert_kernel(ws["down"], spec4, s_h, 2)
        y = down(h, path="fused")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        tb = {n_: lay.table_bytes() for n_, lay in
              (("gate", gate), ("up", up), ("down", down))}
        log(f"qwen3-0.6b MLP ({QWEN_D} -> {QWEN_FF} -> {QWEN_D}), 4-bit, "
            f"group 2: tables " + ", ".join(f"{k} {v / 1e9:.2f} GB"
                                            for k, v in tb.items())
            + f"; built and run in {build_s:.1f} s; launches {launches}")
        require(sum(tb.values()) == mlp_table_bytes(QWEN_D, QWEN_FF, 4, 2, 4),
                "MLP table bytes differ from mlp_table_bytes")
        layers = []
        for name, got, xin, s in (("gate", g, x, s_in), ("up", u, x, s_in),
                                  ("down", y, h, s_h)):
            want = fake_quant(xin, spec4, s) @ ws[name]
            err = float((got - want).abs().max())
            tol = 1e-4 * float(want.abs().max())
            layers.append({"proj": name, "max_abs_err": err, "tol": tol})
            log(f"  {name}: |fused - fake_quant(x) @ W| {err:.3e} (tol "
                f"{tol:.3e} = 1e-4 max|dense|: float32 sums of up to "
                f"{xin.shape[-1]} products in another order)")
            require(err <= tol, f"PCILTLinear {name} disagrees with the dense "
                    f"product on the quantized grid")
        require(launches == {"fused_gemv": 3},
                f"the MLP did not run through kernel 9: {launches}")
        out["mlp"] = {"table_bytes": tb, "seconds": build_s,
                      "layers": layers, "launches": launches}
        del gate, up, down, ws

        filt = torch.randn(CONV_K, CONV_C, generator=gen, device="cuda") * 0.5
        sig = torch.randn(B, CONV_T, CONV_C, generator=gen, device="cuda")
        s = float(calibrate(sig, spec2))
        lay = convert_dwconv(filt, spec2, s)
        ops.reset_launches()
        yk = lay(sig, path="kernel")
        torch.cuda.synchronize()
        dl = {k: v for k, v in ops.LAUNCHES.items() if v}
        yf = lay(sig, path="fused")
        # CAUSAL: k - 1 code-0 rows in front, as the host-packed path pads
        codes = F.pad(quantize(sig, spec2, s).int(), (0, 0, CONV_K - 1, 0))
        off = pack_offsets(torch.stack([codes[:, j:j + CONV_T]
                                        for j in range(CONV_K)], -1),
                           spec2.bits, CONV_K)[..., 0]
        plain = pcilt_dwconv1d_ref(off, lay.tables)
        torch.cuda.synchronize()
        edge = bool(torch.equal(yk[:, CONV_K - 1:], yf[:, CONV_K - 1:]))
        exact = bool(torch.equal(yk, plain))
        log(f"mamba2-130m conv frontend (C {CONV_C}, k {CONV_K}, 2-bit): "
            f"tables {lay.table_bytes() / 2**20:.2f} MiB; kernel path on "
            f"[{B}, {CONV_T}, {CONV_C}]: equals fused from t >= {CONV_K - 1}"
            f" {edge}, equals its plain version {exact}; launches {dl}")
        require(edge, "PCILTDwConv1d kernel path differs from the fused one")
        require(exact, "PCILTDwConv1d kernel path differs from its plain "
                "version")
        require(dl == {"dwconv1d_host": 1},
                f"the dwconv layer did not run through kernel 12: {dl}")
        out["dwconv"] = {"table_bytes": lay.table_bytes(),
                         "equal_fused_past_edge": edge,
                         "equal_plain": exact, "launches": dl}
    report["single_layers"] = out
    return {**launches, **dl}


# ----------------------------------------------------------------------------
# phase 10: generalized plans, custom functions and scalar shared tables
# ----------------------------------------------------------------------------


def plans_and_extensions(torch, ops, report):
    """The paper's extensions 1-3 at qwen3-0.6b's gate width (d 1024 ->
    d_ff 3072, seeded weights, a seeded [4, 1024] input, 4-bit activations,
    group 2, float32 tables, one table set at a time).  For each SegmentPlan
    of :func:`qwen_plans`: ``pcilt_linear(plan=, path="fused")`` (kernel 11)
    against its plain version, against ``path="kernel"`` (kernel 6 over
    ``plan.pack``) and against the dense oracle on the quantized grid
    (within 1e-4 of its largest output); ``perm`` bit-equal to kernel 9 on
    ``x[:, perm]``.  An exact-grid probe (integer weights, scale 0.5, [4,
    64] -> 128, a -1 slot and a reused position): kernel 11, the host path
    and the oracle bit-equal.  Extension 2: ``build_grouped_tables(fn=
    log_mul_fn)`` through kernel 9 against the gather path and the direct
    sum of ``log_mul_fn``.  Extension 3: ``build_shared_tables`` of the
    gate's 4-bit-quantized weights through ``path="shared"`` (kernel 3 at
    group 1) against ``materialize()`` + gather and the dense product.
    Returns the launches."""
    import numpy as np

    from repro_torch.core import (QuantSpec, SegmentPlan,
                                  build_grouped_tables, build_shared_tables,
                                  calibrate, dequantize, fake_quant,
                                  log_mul_fn, pcilt_linear, quantize)

    gen = torch.Generator(device="cuda").manual_seed(13)
    spec = QuantSpec(4, True)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {"plans": {}}

    def counted(fn):
        """Run one call of the path, its launches counted from 0."""
        ops.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        return res

    def within(what, got, want, ref):
        err = float((got - want).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        log(f"  {what}: max |d| {err:.3e} (tol {tol:.3e} = 1e-4 of the "
            f"largest output)")
        require(err <= tol, f"phase 10 {what}: {err} > {tol}")
        return err

    with torch.no_grad():
        w = torch.randn(QWEN_D, QWEN_FF, generator=gen, device="cuda") \
            * QWEN_D ** -0.5
        x = torch.randn(B, QWEN_D, generator=gen, device="cuda")
        s = float(calibrate(x, spec))
        codes = quantize(x, spec, s)
        for name, plan in qwen_plans(torch, w).items():
            t0 = time.perf_counter()
            tabs = build_grouped_tables(w, spec, s, 2, plan=plan)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            nbytes = tabs.numel() * tabs.element_size()
            yf = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, plan=plan,
                                              path="fused"))
            yk = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, plan=plan,
                                              path="kernel"))
            plain = ops.gemv_plan_plain(x, tabs, plan.on("cuda"), spec, s, 2)
            oracle = torch.einsum(
                "bgj,gjo->bo", dequantize(plan.gather_codes(codes), spec, s),
                plan.gather_weights(w))
            log(f"plan {name}: G {plan.n_segments}, "
                f"{int((plan.index < 0).sum())} unused slots, positions used "
                f"{len(np.unique(plan.index[plan.index >= 0]))} of {QWEN_D}; "
                f"tables {nbytes:,} B built in {build_s:.2f} s")
            rec = {"G": plan.n_segments, "table_bytes": nbytes,
                   "build_s": build_s,
                   "vs_plain": within("kernel 11 vs its plain version", yf,
                                      plain, plain),
                   "vs_host": within("kernel 11 vs path='kernel' "
                                     "(plan.pack, kernel 6)", yf, yk,
                                     oracle),
                   "vs_oracle": within("kernel 11 vs the dense oracle", yf,
                                       oracle, oracle)}
            if name == "perm":
                gather = plan.on("cuda").long().reshape(-1)
                y9 = ops.pcilt_fused_gemv(x[:, gather].contiguous(), tabs,
                                          spec, s, 2)
                rec["equal_kernel9"] = bool(torch.equal(yf, y9))
                log(f"  kernel 11 bit-equal to kernel 9 on x[:, perm]: "
                    f"{rec['equal_kernel9']}")
                require(rec["equal_kernel9"], "kernel 11 on perm differs "
                        "from kernel 9 on the permuted x")
            out["plans"][name] = rec
            del tabs, plain, oracle

        # the exact-grid probe: a -1 slot and a reused position
        cpu = torch.Generator().manual_seed(14)
        pos = torch.randperm(64, generator=cpu)[:63].int()
        idx = torch.cat([pos, torch.tensor([-1], dtype=torch.int32),
                         pos[:2]]).numpy().reshape(-1, 2)
        plan = SegmentPlan(idx)
        kw = torch.randint(-3, 4, (64, 128), generator=gen,
                           device="cuda").float()
        xs = torch.randint(-2, 2, (B, 64), generator=gen,
                           device="cuda").float() * 0.5
        tabs = build_grouped_tables(kw, spec, 0.5, 2, plan=plan)
        pf = counted(lambda: pcilt_linear(xs, tabs, spec, 0.5, 2, plan=plan,
                                          path="fused"))
        pk = counted(lambda: pcilt_linear(xs, tabs, spec, 0.5, 2, plan=plan,
                                          path="kernel"))
        po = torch.einsum("bgj,gjo->bo", dequantize(
            plan.gather_codes(quantize(xs, spec, 0.5)), spec, 0.5),
            plan.gather_weights(kw))
        exact = bool(torch.equal(pf, pk) and torch.equal(pf, po))
        log(f"plan exact-grid probe [{B}, 64] -> 128, G {plan.n_segments} "
            f"(a -1 slot, a reused position): kernel 11, path='kernel' and "
            f"the oracle bit-equal: {exact}")
        require(exact, "the exact-grid plan probe is not bit-equal")
        out["exact_probe"] = {"equal": exact, "G": plan.n_segments}

        # extension 2: a custom convolution function
        t0 = time.perf_counter()
        tabs = build_grouped_tables(w, spec, s, 2, fn=log_mul_fn)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        yf = counted(lambda: pcilt_linear(x, tabs, spec, s, 2, path="fused"))
        yg = pcilt_linear(x, tabs, spec, s, 2, path="gather")
        direct = log_mul_fn(w[None], dequantize(codes, spec, s)[:, :, None]) \
            .sum(1)
        log(f"log_mul_fn tables: G {tabs.shape[0]}, "
            f"{tabs.numel() * 4:,} B built in {build_s:.2f} s (chunked over "
            f"V)")
        out["log_mul"] = {
            "table_bytes": tabs.numel() * 4, "build_s": build_s,
            "vs_gather": within("kernel 9 on log_mul_fn tables vs gather",
                                yf, yg, direct),
            "vs_direct": within("kernel 9 vs sum log_mul_fn(w, val)", yf,
                                direct, direct)}
        del tabs, direct

        # extension 3: scalar shared tables of 4-bit weights
        wspec = QuantSpec(4, True)
        w4 = fake_quant(w, wspec, calibrate(w, wspec))
        t0 = time.perf_counter()
        st = build_shared_tables(w4, spec, s)
        pool = st.as_grouped_pool()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ys = counted(lambda: pcilt_linear(x, st, spec, s, 2, path="shared"))
        yd = pcilt_linear(x, st.materialize(), spec, s, 1, path="gather")
        dense = fake_quant(x, spec, s) @ w4
        pool_b = pool.pool.numel() * pool.pool.element_size()
        log(f"shared tables: {st.actual_cardinality} unique weights, a "
            f"[{st.pool.shape[0]}, {st.pool.shape[1]}] pool; 1-wide segment "
            f"pool [{', '.join(map(str, pool.pool.shape))}] = {pool_b:,} B "
            f"built in {build_s:.2f} s")
        require(st.actual_cardinality <= 16, "4-bit weights with more than "
                "16 values")
        out["shared"] = {
            "actual_cardinality": st.actual_cardinality,
            "pool_shape": list(pool.pool.shape), "pool_bytes": pool_b,
            "build_s": build_s,
            "vs_materialize": within("kernel 3 (group 1) vs materialize() + "
                                     "gather", ys, yd, dense),
            "vs_dense": within("kernel 3 vs the dense product", ys, dense,
                               dense)}
        del st, pool, yd
    seen = {k: v for k, v in launches.items() if v}
    log(f"  launches: {seen}")
    require(seen == {"gemv_plan": 4, "gemv_host": 4, "fused_gemv": 1,
                     "shared_gemv": 1},
            f"phase 10 did not run through kernels 11, 6, 9 and 3: {seen}")
    out["launches"] = seen
    report["plans"] = out
    return seen


# ----------------------------------------------------------------------------
# phase 11: learnable tables
# ----------------------------------------------------------------------------


def learnable(torch, ops, report):
    """``launch.learnable_pcilt.run(device="cuda")``: every granularity's
    loss must fall and stay finite, each trained table served through the
    host-packed GEMV (kernel 6) must equal the gather path it trained on
    within 1e-5, and the final losses must agree with the same run on the
    CPU within 1e-4 relative (the same seeded data and base tables; the
    sums run in another order).  Returns the launches."""
    from repro_torch.launch import learnable_pcilt

    ops.reset_launches()
    res = learnable_pcilt.run(device="cuda", log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    cpu = learnable_pcilt.run(device="cpu", log=lambda m: None)
    for gran, (l0, l1) in res["losses"].items():
        require(l1 == l1 and abs(l1) != float("inf") and l1 < l0,
                f"learnable {gran}: loss {l0} -> {l1}")
        require(res["kernel_max_abs_err"][gran] <= 1e-5,
                f"learnable {gran}: the kernel path differs from gather")
        rel = abs(l1 - cpu["losses"][gran][1]) / abs(cpu["losses"][gran][1])
        log(f"  {gran}: final loss on the card {l1:.6f}, on the CPU "
            f"{cpu['losses'][gran][1]:.6f} (relative difference {rel:.2e})")
        require(rel <= 1e-4, f"learnable {gran}: the card's final loss "
                f"differs from the CPU's by {rel:.2e}")
    log(f"  launches: {launches}")
    require(launches == {"gemv_host": 4},
            f"the trained tables were not served through kernel 6: "
            f"{launches}")
    report["learnable"] = {**res, "cpu_losses": cpu["losses"],
                           "launches": launches}
    return launches


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
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    require(clk and clk[0].replace(".", "").isdigit(),
            f"nvidia-smi gave no clocks.max.sm: {clk}")
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "sm_count": torch.cuda.get_device_properties(0)
              .multi_processor_count, "sm_clock_max_mhz": float(clk[0]),
              "checks": [], "profile_retries": []}
    log(f"{report['sm_count']} SMs, clocks.max.sm {clk[0]} MHz")

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s (nvcc, {len(build.SOURCES)} "
        f"sources in parallel)")
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
    time_slice3_kernels(torch, ops, report, rows)
    torch.cuda.empty_cache()
    time_plan_kernel(torch, ops, report, rows)
    torch.cuda.empty_cache()
    time_conv_kernels(torch, ops, report, rows)
    log(f"profiles taken again: {len(report['profile_retries'])}")
    # each path's launches, counted from 0 just before it runs
    launches = dict.fromkeys(ops.LAUNCHES, 0)

    report["phase_s"] = {}

    def count(phase):
        """Run one path's phase, add its launches, keep its seconds."""
        t0 = time.perf_counter()
        for k, v in phase(torch, ops, report).items():
            launches[k] += v
        report["phase_s"][phase.__name__] = time.perf_counter() - t0
        log(f"({phase.__name__}: {report['phase_s'][phase.__name__]:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    for phase in (serve, paper_cnn, serve_paired, paired_parity,
                  single_layers, plans_and_extensions, learnable):
        count(phase)

    primary = {"gemv_stacked": "wz,wx", "dwconv1d": "window counters",
               "shared_gemv": "head", "fused_conv2d": "fused_conv2d conv4",
               "shared_conv2d": "shared_conv2d conv4",
               "gemv_host": "gemv_host conv4",
               "conv2d_host": "conv2d_host conv4",
               "gemv_paired_stacked": "paired wz",
               "fused_gemv": "fused_gemv gate",
               "gemv_paired": "gemv_paired wz",
               "dwconv1d_host": "dwconv1d_host signal",
               "gemv_plan": "gemv_plan perm"}
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
        for extra in ("plain_shape", "direct_ms", "fetch_floor_ms"):
            if extra in r:
                kernels[-1][extra] = r[extra]
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
