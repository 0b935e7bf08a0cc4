#!/usr/bin/env python3
"""Kernels 6 and 2 (the host-packed GEMV and the fused dwconv) under other
constants and with a stage removed, on the card.

    python3 scripts/host_gemv_sweep.py [variant,variant,...] [layers]

Builds variants of ``src/repro_torch/kernels/csrc/pcilt_gemv.cu`` (``h:``
names) and ``pcilt_dwconv1d.cu`` (``f:`` names), each with other values of
the new design's constants (a text edit of their ``constexpr`` lines) or a
stage removed (a text edit of the source), into ``build/sweep_host/``, and
times each variant's new design beside the committed library's kept one
("direct", forced):

* kernel 6 at the paper CNN's conv layers (``layers``, default ``4``: a
  comma-separated list of layer indices) on a 1024x768 image, on the real
  offsets of each layer (the dense fake-quant chain of the seeded network,
  as ``chip_smoke.py`` phase 4), float32 tables, beside the fetch floor
  (the fetch-adds' 4-byte cells at 128 B a clock per SM);
* kernel 2 at the decode window (``[4, 4, 1792]``, 4-bit, 4 taps, V 65536,
  with counters, over 8 layers' tables in turn, as ``chip_smoke.py``) and
  at the full-sequence signal (``[4, 2048, 1792]``, 2-bit, CAUSAL, with
  counters), beside the kept design with and without the zero fill of its
  stats that it needs, and the tiled design without counters.

Each time is profiler device time with L2 flushed before every call
(``chip_smoke.time_calls``).  The committed library's new designs are held
to their plain versions first (kernel 6 bit-equal on the layer's offsets
with some set out of range, through integer-valued tables; kernel 2 exact,
counters exact); each variant's output to the committed one (bit-equal).
The ablations (marked ``timing only``) give wrong results.

``x:crossover`` times kernel 6's three designs of the committed library
(``split``, ``staged`` and ``direct``, each forced through
``ops._gemv_host``) over ``CROSS_CASES``: serve_pcilt's gate and the paper
CNN's conv1 at ``CROSS_ROWS`` rows, the gate in bfloat16, the CNN's five
layers at a 64x48 and a 256x192 image, and a narrow O at up to 2**20 rows
(seeded random tables and offsets), each design first held to the plain
version (within 1e-4 of its largest output; 1e-2 in bfloat16), and prints
the fastest design at each row count beside the one
``ops.gemv_host_variant`` chooses.

Variants: ``h:base`` and ``f:base`` (the committed sources), ``x:crossover``
and the names in ``VARIANTS`` below.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

HOST_SRC, DW_SRC = "pcilt_gemv.cu", "pcilt_dwconv1d.cu"
#: kernel 6's stages, removed one at a time (timing only): ``nofetch``
#: adds no staged cell, ``nooffload`` reads no offsets (a synthetic byte
#: per row and segment), ``noissue`` copies no slice, ``nostore`` stores no
#: offset byte and marks no row, ``fetchonly`` all three but the fetch
H_NOFETCH = [("    if (s_flag[s])\n      fetch_slot_masked", "    if (false)\n"
              "      fetch_slot_masked"),
             ("    else\n      fetch_slot<T>(acc, s_tab, off, at);",
              "    else if (false)\n      fetch_slot<T>(acc, s_tab, off, at);")]
H_NOOFFLOAD = [("if (m0 + r < M) cp_async<4 * E>(s_raw + r * kChunk + q0, src);",
                "for (int e = 0; e < E; ++e) s_raw[r * kChunk + q0 + e] = "
                "(r * 7 + g + e) & 255;")]
H_NOISSUE = [("    issue(g + kAhead);\n", "    cp_async_commit();\n")]
H_NOSTORE = [("    if (h % kChunk == 0 && h < G) store(h / kChunk);", "")]
#: the other block order: the blocks of a row tile consecutive (resident
#: together), so the offsets are read about once and the table once a wave
H_ROWMAJOR = [("  const long long rt = blockIdx.x % n_rtiles;  // row tile\n"
               "  const int ct = (int)(blockIdx.x / n_rtiles);  // column tile",
               "  const int n_ctiles = (O + kColTile - 1) / kColTile;\n"
               "  const long long rt = blockIdx.x / n_ctiles;\n"
               "  const int ct = (int)(blockIdx.x % n_ctiles);")]
#: kernel 2's (timing only): ``empty`` returns at once (the launch alone),
#: ``nogather`` reads no table cell (the packed offset as the value)
F_EMPTY = [("  int bx = blockIdx.x, by = blockIdx.y, ny = gridDim.y;\n",
            "  if (rows > 0) return;\n"
            "  int bx = blockIdx.x, by = blockIdx.y, ny = gridDim.y;\n")]
F_NOGATHER = [("cell[n] = tab[(size_t)(c + n) * V + o[n]];",
               "cell[n] = pcilt::from_f32<T>((float)o[n]);")]
#: a channel a lane at every grid size (4-byte taps), 4 channels a lane at
#: every grid size (the decode window too), and the ticket at every grid
#: size
F_NARROW = [("const bool wide = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&",
             "const bool wide = false && (uintptr_t)x % 16 == 0 &&")]
F_WIDE = [("if ((long long)d.tiles * rows > kDwClusterBlocks) {",
           "if (true) {")]
F_TICKET = [("} else if (nd > kDwClusterBlocks) {", "} else if (true) {")]
#: name -> (source, constants, edits, results right)
VARIANTS = {
    "h:base": (HOST_SRC, {}, [], True),
    "h:rowmajor": (HOST_SRC, {}, H_ROWMAJOR, True),
    "h:chunk4": (HOST_SRC, {"kChunk": 4}, [], True),
    "h:nofetch": (HOST_SRC, {}, H_NOFETCH, False),
    "h:nooffload": (HOST_SRC, {}, H_NOOFFLOAD, False),
    "h:noissue": (HOST_SRC, {}, H_NOISSUE, False),
    "h:nostore": (HOST_SRC, {}, H_NOSTORE, False),
    "h:fetchonly": (HOST_SRC, {}, H_NOOFFLOAD + H_NOISSUE + H_NOSTORE,
                    False),
    "f:base": (DW_SRC, {}, [], True),
    "f:target264": (DW_SRC, {"kDwTiledTargetBlocks": 264}, [], True),
    "f:narrow": (DW_SRC, {}, F_NARROW, True),
    "f:wide": (DW_SRC, {}, F_WIDE, True),
    "f:lanes256": (DW_SRC, {"kDwWideLanes": 256}, [], True),
    "f:ticket": (DW_SRC, {}, F_TICKET, True),
    "f:empty": (DW_SRC, {}, F_EMPTY, False),
    "f:nogather": (DW_SRC, {}, F_NOGATHER, False),
}
STAGED, DIRECT = "gemv_host_staged_kernel", "gemv_host_kernel"
SPLIT = "gemv_host_split"  # its one-pass and slab kernels
#: the crossover's cases: (what, G, V, O, table dtype, row counts)
CROSS_ROWS = (1, 4, 16, 64, 256, 1023, 1024, 4096)
_CNN_ROWS = (64 * 48, 256 * 192)
CROSS_CASES = (
    ("gate", 512, 256, 3072, "float32", CROSS_ROWS + (384, 512, 768)),
    ("gate bf16", 512, 256, 3072, "bfloat16", (64, 256, 384, 512, 768,
                                               1023)),
    ("conv1", 1250, 256, 80, "float32", CROSS_ROWS),
    ("cnn conv0", 25, 256, 50, "float32", _CNN_ROWS),
    ("cnn conv1", 1250, 256, 80, "float32", _CNN_ROWS),
    ("cnn conv2", 2000, 256, 120, "float32", _CNN_ROWS),
    ("cnn conv3", 3000, 256, 200, "float32", _CNN_ROWS),
    ("cnn conv4", 5000, 256, 350, "float32", _CNN_ROWS),
    ("narrow", 64, 16, 4, "float32", (4096, 65536, 1 << 20)))
TILED, DW_DIRECT = "dwconv1d_tiled_kernel", "dwconv1d_kernel"


def build_variants(names, build):
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "sweep_host")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(names):  # a name listed twice is timed twice
        src, consts, edits, _ = VARIANTS[name]
        text = open(os.path.join(csrc, src)).read()
        for const, value in consts.items():
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise SystemExit(f"variant {name}: no constant {const}")
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the edit's anchor is not "
                                 f"in the source once: {old!r}")
            text = text.replace(old, new)
        tag = name.replace(":", "_")
        cu = os.path.join(out_dir, f"{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib_{tag}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name} did not build (left out):\n{text}",
                  flush=True)
            continue
        fn, regs = "", []
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("for")[-1].strip()
            elif re.search(r"[1-9]\d* bytes spill", line) or "Used" in line:
                if "staged" in fn or "tiled" in fn:
                    regs.append(f"{fn[:70]}: {line.split(':')[-1].strip()}")
        print(f"built {name}: {VARIANTS[name][1]}\n  " + "\n  ".join(regs),
              flush=True)
        cdll = ctypes.CDLL(lib)
        sym = "pcilt_gemv_host" if name.startswith("h:") else "pcilt_dwconv1d"
        for dt in ("f32", "bf16"):
            f = getattr(cdll, f"{sym}_{dt}")
            f.argtypes = build._SIGNATURES[sym]
            f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("host_gemv_sweep: no CUDA device")
        return 2
    import chip_smoke
    from repro_torch.core.lut_layers import build_dwconv_tables
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.core.lut_layers import flatten_filters
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.kernels import build, ops
    from repro_torch.models.cnn import dm_conv2d

    names = sys.argv[1].split(",") if len(sys.argv) > 1 and sys.argv[1] \
        else list(VARIANTS)
    layers = [int(i) for i in sys.argv[2].split(",")] \
        if len(sys.argv) > 2 else [4]
    crossover = "x:crossover" in names
    names = [n for n in names if n != "x:crossover"]
    build.build_all()
    libs = build_variants(names, build)
    names = [n for n in names if n in libs]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{card}; {sms} SMs, clocks.max.sm {clk} MHz", flush=True)
    flush = chip_smoke.L2Flush(torch)
    stream = torch.cuda.current_stream().cuda_stream
    bad = []

    def timed(calls, kernel=None, reps=5, warmup=2):
        return chip_smoke.time_calls(torch, calls, flush, kernel, reps=reps,
                                     warmup=warmup)["ms"]

    def report(what, name, ms, ref_ms, err, right, unit="ms", scale=1.0):
        ok = err == 0.0 if right else True
        if not ok:
            bad.append((what, name))
        print(f"{what:28s} {name:14s} {ms * scale:10.3f} {unit}  "
              f"({ms / ref_ms:5.3f} x base)  max|d| {err:.3e} "
              f"{'ok' if ok else 'FAIL'}{'' if right else ' (timing only)'}",
              flush=True)

    # -- kernel 6's three designs across the row counts
    if crossover:
        gen = torch.Generator(device="cuda").manual_seed(6)
        for what, G, V, O, dt, rows in CROSS_CASES:
            dtype = getattr(torch, dt)
            tabs = torch.randn(G, V, O, generator=gen, device="cuda").to(dtype)
            offs = torch.randint(0, V, (max(rows), G), generator=gen,
                                 device="cuda", dtype=torch.int32)
            rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            best = {}
            for M in sorted(rows):
                off = offs[:M].contiguous()
                # the plain version over a crop of rows (it gathers M x G
                # x O cells)
                crop = off[:4096]
                want = ops.gemv_host_plain(crop, tabs)
                times = {}
                for design, kname in (("split", SPLIT), ("staged", STAGED),
                                      ("direct", DIRECT)):
                    got = ops._gemv_host(off, tabs, variant=design)
                    torch.cuda.synchronize()
                    err, ok = chip_smoke.close(torch, got[:4096], want,
                                               rtol)
                    if not ok:
                        bad.append((f"crossover {what} M{M}", design))
                    times[design] = timed(
                        [lambda d=design: ops._gemv_host(off, tabs,
                                                         variant=d)],
                        kname)
                    print(f"crossover {what} G{G} V{V} O{O} M{M:7d} "
                          f"{design:7s} {times[design] * 1e3:10.2f} us  "
                          f"max|d| {err:.3e} {'ok' if ok else 'FAIL'}",
                          flush=True)
                chosen = ops.gemv_host_variant(M, G, V, O,
                                               tabs.element_size())
                best[M] = min(times, key=times.get)
                print(f"crossover {what} M{M:7d}: fastest {best[M]} "
                      f"({times[best[M]] * 1e3:.2f} us), chosen {chosen} "
                      f"({times[chosen] * 1e3:.2f} us, "
                      f"{times[chosen] / times[best[M]]:.3f} x)", flush=True)
            print(f"crossover {what}: fastest by rows {best}", flush=True)
            del tabs, offs
            torch.cuda.empty_cache()

    # -- kernel 6 at the paper CNN's layers on their real offsets
    hnames = [n for n in names if n.startswith("h:")]
    if hnames:
        model, params, scales, x = chip_smoke.paper_cnn_setup(torch)
        spec, k = model.act_spec, model.k
        h = x
        committed = build.library("gemv_host").pcilt_gemv_host_f32
        with torch.no_grad():
            for i, (C, O) in enumerate(chip_smoke.conv_layers(model)):
                name = f"conv{i}"
                w, s = params[name], scales[name]
                if i not in layers:
                    h = torch.relu(dm_conv2d(h, w, spec, s))
                    continue
                tabs = build_grouped_tables(flatten_filters(w, 1), spec, s, 1)
                xp = chip_smoke.padded(h, k, 1)
                G, V, _ = tabs.shape
                off = chip_smoke.host_offsets(torch, xp, spec, s, k, G)
                flat = off.view(-1, G)
                M = flat.shape[0]
                what = f"gemv_host conv{i} M{M} G{G} O{O}"
                floor = M * G * O * 4 / (sms * 128 * clk * 1e6) * 1e3
                out = torch.empty((M, O), device="cuda")

                def launch(f, variant, dst=out, t=tabs, o=flat):
                    err = f(o.data_ptr(), t.data_ptr(), dst.data_ptr(), M, G,
                            V, O, variant, stream)
                    if err:
                        raise RuntimeError(f"{what}: cudaError {err}")

                # the committed staged design against its plain version on
                # integer-valued tables, some offsets out of range (a crop of
                # rows: the plain version gathers M x G x O cells)
                rows = min(M, 4096)
                probe = flat[:rows].clone()
                probe.view(-1)[::997] = -1
                probe.view(-1)[1::1499] = 2 ** 31 - 1
                itabs = torch.randint(-3, 4, tabs.shape, device="cuda").float()
                got = torch.empty((rows, O), device="cuda")
                err = committed(probe.data_ptr(), itabs.data_ptr(),
                                got.data_ptr(), rows, G, V, O, 0, stream)
                want = ops.gemv_host_plain(probe, itabs)
                torch.cuda.synchronize()
                ok = err == 0 and torch.equal(got, want)
                print(f"{what}: committed staged vs plain (exact grid, "
                      f"offsets out of range): {'bit-equal' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    bad.append((what, "plain"))
                del itabs, got, want, probe
                ref = torch.empty_like(out)
                launch(committed, 0, ref)
                base_ms = timed([lambda: launch(committed, 0)], STAGED,
                                reps=1, warmup=1)
                print(f"{what:28s} {'fetch floor':14s} {floor:10.3f} ms",
                      flush=True)
                d_ms = timed([lambda: launch(committed, 1)], DIRECT, reps=1,
                             warmup=1)
                report(what, "direct", d_ms, base_ms, 0.0, True)
                for n in hnames:
                    f = libs[n].pcilt_gemv_host_f32
                    got = torch.empty_like(out)
                    launch(f, 0, got)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    ms = timed([lambda f=f: launch(f, 0)], STAGED, reps=1,
                               warmup=1)
                    report(what, n, ms, base_ms, err, VARIANTS[n][3])
                del off, flat, out, ref, tabs
                torch.cuda.empty_cache()
                h = torch.relu(dm_conv2d(h, w, spec, s))
        del model, params, x, h
        torch.cuda.empty_cache()

    # -- kernel 2 at the decode window and the full-sequence signal
    fnames = [n for n in names if n.startswith("f:")]
    if fnames:
        gen = torch.Generator(device="cuda").manual_seed(5)
        lib = build.library("dwconv1d")
        committed = lib.pcilt_dwconv1d_f32
        scratch = ops._dwconv_scratch(lib, torch.device("cuda"))
        C, K = 1792, 4
        for what, (Bq, T), bits, L, causal in (
                ("dwconv window [4, 4, 1792]", (4, 4), 4, 8, False),
                ("dwconv signal [4, 2048, 1792]", (4, 2048), 2, 1, True)):
            spec = QuantSpec(bits, True)
            filt = torch.randn(L, K, C, generator=gen, device="cuda") * 0.5
            xs = torch.randn(Bq, T + (K - 1 if causal else 0), C,
                             generator=gen, device="cuda") * 1.2
            if causal:
                xs[:, :K - 1] = 0.0
            scale = 0.3
            tabs = [build_dwconv_tables(filt[l], spec, scale)
                    for l in range(L)]
            V = tabs[0].shape[1]
            Tp = xs.shape[1]
            To = Tp - K + 1
            out = torch.empty((Bq, To, C), device="cuda")
            stats = torch.empty(2, dtype=torch.int32, device="cuda")

            def launch(f, variant, t, counters=1, dst=out, st=stats):
                err = f(xs.data_ptr(), t.data_ptr(), dst.data_ptr(),
                        st.data_ptr(), scratch.data_ptr(), Bq, Tp, C, V, K,
                        bits, spec.zero_point, scale, counters, variant,
                        stream)
                if err:
                    raise RuntimeError(f"{what}: cudaError {err}")

            want, wc, wr = ops.dwconv1d_plain(xs, tabs[0], spec, scale, K,
                                              with_stats=True)
            launch(committed, 0, tabs[0])
            torch.cuda.synchronize()
            ok = (torch.equal(out, want) and int(stats[0]) == int(wc)
                  and float(stats[1:].view(torch.float32)[0]) == float(wr))
            print(f"{what}: committed tiled vs plain (outputs, counters): "
                  f"{'exact' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append((what, "plain"))
            ref = out.clone()
            reps = 4 if L > 1 else 8
            base_ms = timed([lambda t=t: launch(committed, 0, t)
                             for t in tabs] * reps, TILED)
            zeros = torch.empty(2, dtype=torch.int32, device="cuda")

            def kept(t):
                zeros.zero_()
                launch(committed, 1, t, st=zeros)

            d_ms = timed([lambda t=t: launch(committed, 1, t, st=zeros)
                          for t in tabs] * reps, DW_DIRECT)
            fill_ms = timed([lambda t=t: kept(t) for t in tabs] * reps)
            nc_ms = timed([lambda t=t: launch(committed, 0, t, 0)
                           for t in tabs] * reps, TILED)
            report(what, "direct", d_ms, base_ms, 0.0, True, "us", 1e3)
            report(what, "direct + fill", fill_ms, base_ms, 0.0, True, "us",
                   1e3)
            report(what, "no counters", nc_ms, base_ms, 0.0, True, "us", 1e3)
            for n in fnames:
                f = libs[n].pcilt_dwconv1d_f32
                got = torch.empty_like(out)
                launch(f, 0, tabs[0], dst=got)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ms = timed([lambda t=t, f=f: launch(f, 0, t) for t in tabs]
                           * reps, TILED)
                report(what, n, ms, base_ms, err, VARIANTS[n][3], "us", 1e3)
            del tabs, xs, out
            torch.cuda.empty_cache()
        require_zero = int(scratch.abs().sum())
        print(f"tiled scratch after the sweep: {scratch.tolist()}", flush=True)
        if require_zero:
            bad.append(("dwconv", "scratch not left zeroed"))
    if bad:
        print(f"FAILED: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
