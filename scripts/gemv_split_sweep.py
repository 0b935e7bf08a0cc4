#!/usr/bin/env python3
"""The fused GEMV's split design under other constants, on the card.

    python3 scripts/gemv_split_sweep.py [variant,variant,...]
    python3 scripts/gemv_split_sweep.py x:rows [shape,...]
    python3 scripts/gemv_split_sweep.py st:base,st:noload,...

Builds variants of ``src/repro_torch/kernels/csrc/pcilt_gemv_stacked.cu``
and of the split it shares with kernel 6 (``pcilt_split.cuh``), each with
other values of the split design's constants (a text edit of their
``constexpr`` lines), another cache hint on the table loads, or a stage
removed, into ``build/sweep/<variant>/``, and times each variant's split
kernel at every shape a decode step launches — kernel 1 at mamba2-130m's
five projections (4-bit, group 2, B 4; wx and wo with counters, as the
engine launches them) and kernel 8 at the paired decode's (2-bit, group
2, segment-major stacks) — at qwen3-0.6b's gate (kernel 9) and at wz on
one layer (the same 600 MB each call, against 8 layers in turn: a probe
of address translation), beside the kept design ("direct", forced) of the
committed library.  Each time is profiler device time with L2 flushed
before every call (``chip_smoke.time_calls``); each variant's sums are
held to the committed split kernel's (bit-equal when the split is the
same, else within 1e-4 of the largest output).  Prints one line per shape
and variant, and per variant the sum over a decode step's 144 launches of
kernel 1 (unpaired) and of kernel 8 (paired).

Variants: ``base`` (the committed source) and the names in ``VARIANTS``
below; the ablations remove a stage by a text edit of the source, as
``scripts/conv2d_ablation.py`` does (timing only: their sums are wrong and
marked so).

``x:rows`` times kernel 9's split and staged designs (each forced) from 4
to 4096 rows (``ROWS``) at ``ROW_SHAPES`` (llava-next-mistral-7b's and
deepseek-coder-33b's group-1 down projections, qwen3-0.6b's gate at group
2 and its down projection at group 1), float32 and bfloat16 tables,
beside ``torch.matmul`` on the quantized grid, the bytes bound (the distinct table rows this run's offsets name, x
and the output once) and the whole table read once, and prints
``kernels.ops.gemv_fused_variant``'s choice: the points its rule follows.
Name shapes after ``x:rows`` to time only those (``llava``, ``deepseek``,
``gate``, ``down1``).  Its output is long: send it to a file.

``st:<variant>`` rebuilds kernel 9's staged design
(``pcilt_gemv_staged.cu``) and times each variant (``STAGED`` below:
``base``, or a stage removed: ``noload`` copies no table row, ``nostage``
packs synthetic offsets (no activation loads, no quantize), ``nofetch``
adds nothing from shared memory, ``noreduce`` skips the cluster's sum) at
llava's down projection (B 32) and qwen3-0.6b's gate at 768 rows, the
profile ``ncu`` cannot give on the card.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: name -> (constants, source edits).  The edits remove one stage of the
#: split kernel for timing only (their sums are wrong): ``noquant`` packs
#: offsets from a synthetic value (no activation loads), ``nofetch`` loads
#: no table cell, ``noreduce`` skips the cluster's reduction (no cluster
#: barrier, no distributed shared memory), ``empty`` all three.
NOQUANT = ("\n          xv = xs[j];",
           "\n          xv = (float)((g * 5 + j * 3 + r * 7) % 15 - 7) * "
           "scale;")
NOFETCH = ("if (gg < ge && r < nb && (!CHECKED || o[r] >= 0) &&\n"
           "              c + k * VEC < O)", "if (false)")
NOREDUCE = [("if (cs > 1) {  // all the ranks' loads in flight, "
             "then the adds", "if (false) {"),
            ("  if (cs == 1) {\n    __syncthreads();\n  } else {\n"
             "    cluster.sync();\n  }", "  __syncthreads();"),
            ("  if (cs > 1) cluster.sync();", "")]
#: the table loads with another cache hint: ``ldcs`` evict-first
#: (``ld.global.cs``), ``l2pf`` a 256-byte L2 prefetch on each 16-byte load
LDCS = ("v[u][r][k] = __ldg(reinterpret_cast<const Raw*>(",
        "v[u][r][k] = __ldcs(reinterpret_cast<const Raw*>(")
L2PF = [("// A slot's segments ga .. ge - 1",
         "template <typename R>\n__device__ __forceinline__ R ld_hint(const R* "
         "p) { return __ldg(p); }\ntemplate <>\n__device__ __forceinline__ "
         "uint4 ld_hint<uint4>(const uint4* p) {\n  uint4 v;\n  asm(\"ld.global"
         ".nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\" : "
         "\"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
         "  return v;\n}\n\n// A slot's segments ga .. ge - 1"),
        ("v[u][r][k] = __ldg(reinterpret_cast<const Raw*>(",
         "v[u][r][k] = ld_hint(reinterpret_cast<const Raw*>(")]
#: the segment loop kept rolled (``#pragma unroll 1``): one batch of loads
#: live at a time (a probe of the spills ptxas reported at 255 registers in
#: the counter and bfloat16 instances: it changed no register count)
_LOOP = "  for (int g = ga; g < ge; g += BATCH) {\n"
UNROLL1 = [(_LOOP, "#pragma unroll 1\n" + _LOOP)]
#: the cluster's sum loop kept rolled: one element's 16 rank loads live at
#: a time instead of several elements' (the spill's other candidate), and
#: the block's sum loop with it
ROLLSUM = [("  for (int e = rank * blockDim.x + threadIdx.x; e < E;\n",
            "#pragma unroll 1\n"
            "  for (int e = rank * blockDim.x + threadIdx.x; e < E;\n"),
           ("  for (int e = threadIdx.x; e < E; e += blockDim.x) {\n"
            "    float sum = part[e];",
            "#pragma unroll 1\n"
            "  for (int e = threadIdx.x; e < E; e += blockDim.x) {\n"
            "    float sum = part[e];")]
#: kSegBatch segments a load batch in every instance, as before the
#: counter and bfloat16 instances took 2 (they spill so)
BATCH4 = [("constexpr int kBatch = (COUNTERS || sizeof(T) == 2) ? 2 : "
           "kSegBatch;", "constexpr int kBatch = kSegBatch;")]




#: the staged design's stage removals (timing only): ``noload`` copies no
#: table row, ``noissue`` skips the copy loop (its row-mask reads too),
#: ``nostage`` packs synthetic offsets (no activation loads, no quantize;
#: they name ~15 of 16 rows a segment, more than real data), ``nofetch``
#: adds nothing, ``noreduce`` skips the cluster's sum (reads its own
#: partials), ``empty`` all but the loads; and its other shapes: ``ldg``
#: copies through registers (a 16-byte load, then a store to shared
#: memory) instead of cp.async, ``one``/``two`` run the wide layout as one
#: block of 512 threads or two of 256 an SM (four of 128 committed),
#: ``ring2`` a 2-slice ring (4 committed: 3 segments in flight, not 1)
ST_NOLOAD = ("using pcilt::staged::cp_async;\n",
             "template <int N>\n__device__ __forceinline__ void cp_async("
             "void*, const void*) {}\n")
ST_NOISSUE = ("      if (gl < ns)\n        copy_used<T, CB, NT>(",
              "      if (false)\n        copy_used<T, CB, NT>(")
ST_NOSTAGE = ("            const float xv = xs[j];",
              "            const float xv = (float)((gl * 5 + j * 3 + r * 7) "
              "% 15 - 7) * scale;")
ST_NOFETCH = ("      if (fetching)\n        fetch<T, WIDE, RPT>(",
              "      if (false)\n        fetch<T, WIDE, RPT>(")
ST_NOREDUCE = ("      if (k < cs) peer[k] = cluster.map_shared_rank(part, k)"
               "[e];",
               "      if (k < cs) peer[k] = part[e];")
ST_LDG = ("using pcilt::staged::cp_async;\n",
          "template <int N>\n__device__ __forceinline__ void cp_async("
          "void* d, const void* s) {\n  using R = typename pcilt::RawOf<N>"
          "::type;\n  *reinterpret_cast<R*>(d) = __ldg(reinterpret_cast<"
          "const R*>(s));\n}\n")
STAGED = {"st:base": ({}, []), "st:noload": ({}, [ST_NOLOAD]),
          "st:noissue": ({}, [ST_NOISSUE]),
          "st:nostage": ({}, [ST_NOSTAGE]), "st:nofetch": ({}, [ST_NOFETCH]),
          "st:noreduce": ({}, [ST_NOREDUCE]),
          "st:empty": ({}, [ST_NOISSUE, ST_NOSTAGE, ST_NOFETCH,
                            ST_NOREDUCE]),
          "st:ldg": ({}, [ST_LDG]),
          "st:one": ({"kWideWarps": 16, "kWideBlocks": 1}, []),
          "st:two": ({"kWideWarps": 8, "kWideBlocks": 2}, []),
          "st:ring2": ({"kWideRing": 2, "kNarrowRing": 2}, [])}
#: kernel 9's shapes of ``x:rows``: name -> (G, group, O), 4-bit
#: activations; and the rows
ROW_SHAPES = {"llava": (14336, 1, 4096), "deepseek": (19200, 1, 7168),
              "gate": (512, 2, 3072), "down1": (3072, 1, 1024)}
ROWS = (4, 8, 16, 32, 64, 256, 768, 4096)

VARIANTS = {"base": ({}, []),
            "batch4": ({}, BATCH4),
            "rollsum": ({}, ROLLSUM),
            "rolled": ({}, UNROLL1 + ROLLSUM),
            "unroll1": ({}, UNROLL1),
            "ldcs": ({}, [LDCS]),
            "l2pf": ({}, L2PF),
            "l32m4t132": ({"kMaxLanes": 32, "kMinSegs": 4,
                           "kTargetBlocks": 132}, []),
            "minsegs2": ({"kMinSegs": 2}, []),
            "target132": ({"kTargetBlocks": 132}, []),
            "lanes32": ({"kMaxLanes": 32}, []),
            "warps8": ({"kWarps": 8}, []),
            "batch2": ({"kSegBatch": 2}, []),
            "batch8": ({"kSegBatch": 8}, []),
            "noquant": ({}, [NOQUANT]),
            "nofetch": ({}, [NOFETCH]),
            "noreduce": ({}, NOREDUCE),
            "empty": ({}, [NOQUANT, NOFETCH, *NOREDUCE])}
#: (name, pw, bits, G, O, L, paired, counters, launches a decode step)
SHAPES = [("wz", 2, 4, 384, 1536, 8, False, False, 24),
          ("wx counters", 2, 4, 384, 1536, 8, False, True, 24),
          ("wB,wC", 2, 4, 384, 128, 8, False, False, 48),
          ("wdt", 2, 4, 384, 24, 8, False, False, 24),
          ("wo counters", 2, 4, 768, 768, 8, False, True, 24),
          ("paired wz", 4, 2, 192, 1536, 8, True, False, 24),
          ("paired wx counters", 4, 2, 192, 1536, 8, True, True, 24),
          ("paired wB,wC", 4, 2, 192, 128, 8, True, False, 48),
          ("paired wdt", 4, 2, 192, 24, 8, True, False, 24),
          ("paired wo counters", 4, 2, 384, 768, 8, True, True, 24),
          ("qwen3 gate", 2, 4, 512, 3072, 1, False, False, 0),
          ("wz, one layer", 2, 4, 384, 1536, 1, False, False, 0)]
B = 4


def build_variants(names, build):
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        consts, edits = {**VARIANTS, **STAGED}[name]
        # the split's sources, or the staged design's own
        cu = "pcilt_gemv_staged.cu" if name.startswith("st:") \
            else "pcilt_gemv_stacked.cu"
        texts = {f: open(os.path.join(csrc, f)).read()
                 for f in (cu, "pcilt_split.cuh")}
        for const, value in consts.items():
            hits = 0
            for f, text in texts.items():
                if name.startswith("st:") != f.endswith(".cu"):
                    continue  # the split's constants are the header's, the
                    # staged design's the source's
                texts[f], n = re.subn(rf"constexpr int {const} = \d+;",
                                      f"constexpr int {const} = {value};",
                                      text)
                hits += n
            if hits != 1:
                raise SystemExit(f"variant {name}: no constant {const}")
        for old, new in edits:
            where = [f for f, text in texts.items() if old in text]
            if len(where) != 1 or texts[where[0]].count(old) != 1:
                raise SystemExit(f"variant {name}: the edit's anchor is not "
                                 f"in the sources once: {old!r}")
            texts[where[0]] = texts[where[0]].replace(old, new)
        vdir = os.path.join(out_dir, name.replace(":", "_"))  # its header
        os.makedirs(vdir, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(out_dir, f"lib_{name.replace(':', '_')}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
               os.path.join(vdir, cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name} did not build (left out):\n{text}",
                  flush=True)
            continue
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in text.splitlines() if "Used" in line})
        spills = sorted({line.strip() for line in text.splitlines()
                         if "bytes spill stores" in line
                         and " 0 bytes spill stores" not in line})
        print(f"built {name}: {({**VARIANTS, **STAGED})[name][0]} "
              f"registers {regs} spills {spills or 'none'}", flush=True)
        entry = "pcilt_gemv_staged" if name in STAGED else "pcilt_gemv_fused"
        fns[name] = {}
        for dt in ("f32", "bf16"):
            f = getattr(ctypes.CDLL(lib), f"{entry}_{dt}")
            f.argtypes = build._SIGNATURES[entry]
            f.restype = ctypes.c_int
            fns[name][dt] = f
        if name in VARIANTS:
            fns[name] = fns[name]["f32"]
    return fns


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _distinct_bytes(torch, x, spec, scale, group, G, O, item):
    """The table rows this call's offsets name (each read once), x read
    once and the output written once."""
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import quantize

    off = pack_offsets(quantize(x, spec, scale), spec.bits, group).long()
    V = 1 << (spec.bits * group)
    rows = len(torch.unique(off + torch.arange(G, device=x.device) * V))
    return rows * O * item + x.numel() * 4 + x.shape[0] * O * item


def rows_mode(shapes):
    """``x:rows``: kernel 9's split and staged designs across the rows."""
    import torch

    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               scale_from_amax)
    from repro_torch.kernels import ops
    import chip_smoke

    print(_card(), flush=True)
    flush = chip_smoke.L2Flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(9)
    spec = QuantSpec(4, True)
    for name in shapes:
        G, group, O = ROW_SHAPES[name]
        V, n = 1 << (spec.bits * group), G * group
        w = torch.randn(n, O, generator=gen, device="cuda") * n ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            tabs = (torch.randn(G, V, O, generator=gen, device="cuda")
                    * n ** -0.5).to(dt)
            item = tabs.element_size()
            table_ms = tabs.numel() * item / chip_smoke.HBM_BYTES_PER_S * 1e3
            for B in ROWS:
                x = torch.randn(B, n, generator=gen, device="cuda") * 2.0
                scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
                big = B * G * O * item > 1e11  # the split's loads
                reps, warm, k = (1, 1, 1) if big else (5, 2, 4 if B <= 64
                                                        else 2)

                def launch(design):
                    return ops._launch_gemv("fused_gemv", x, tabs, G, O,
                                            group, V * O, 0, spec, scale,
                                            False, variant=design)

                got = {d: launch(d) for d in ("split", "staged")}
                torch.cuda.synchronize()
                ref = got["split"].float()
                err = float((got["staged"].float() - ref).abs().max())
                tol = (1e-2 if item == 2 else 1e-4) * float(ref.abs().max())
                t = {d: chip_smoke.time_calls(
                    torch, [lambda d=d: launch(d)] * k, flush,
                    ("gemv_split", "gemv_staged"), reps=reps, warmup=warm)
                    ["ms"] for d in ("split", "staged")}
                xq = fake_quant(x, spec, scale).to(dt)
                wq = w.to(dt)
                lib = chip_smoke.time_calls(
                    torch, [lambda: torch.matmul(xq, wq)] * k, flush,
                    reps=reps, warmup=warm)["ms"]
                bound = _distinct_bytes(torch, x, spec, scale, group, G, O,
                                        item) / chip_smoke.HBM_BYTES_PER_S \
                    * 1e3
                pick = ops.gemv_fused_variant(B, G, V, O, item)
                plan = ops.gemv_staged_plan(B, G, V, O, item)
                print(f"rows {name:8s} {str(dt)[6:]:8s} B {B:5d} G {G:5d} "
                      f"V {V:3d} O {O:5d}: split {t['split']:9.4f} ms  "
                      f"staged {t['staged']:9.4f} ms  (split/staged "
                      f"{t['split'] / t['staged']:6.2f})  matmul {lib:8.4f}"
                      f" ms  bound {bound:8.4f} ms  table {table_ms:8.4f} "
                      f"ms  chooser {pick}  plan rows {plan.rows} cluster "
                      f"{plan.cluster}  max|staged - split| {err:.2e} "
                      f"{'ok' if err <= tol else 'FAIL'}", flush=True)
                del x, xq, got, ref
            del tabs
            torch.cuda.empty_cache()
        del w
    return 0


def staged_mode(names):
    """``st:<variant>``: the staged design with a stage removed."""
    import torch

    from repro_torch.core.quantization import QuantSpec, scale_from_amax
    from repro_torch.kernels import build, ops
    import chip_smoke

    fns = build_variants(names, build)
    names = [n for n in names if n in fns]
    print(_card(), flush=True)
    flush = chip_smoke.L2Flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    spec = QuantSpec(4, True)
    for what, B, shape in (("llava down", 32, "llava"),
                           ("qwen3 gate", 768, "gate")):
        G, group, O = ROW_SHAPES[shape]
        V = 1 << (spec.bits * group)
        tabs = torch.randn(G, V, O, generator=gen, device="cuda") \
            * (G * group) ** -0.5
        x = torch.randn(B, G * group, generator=gen, device="cuda") * 2.0
        scale = float(scale_from_amax(0.8 * x.abs().max(), spec))
        want = ops._launch_gemv("fused_gemv", x, tabs, G, O, group, V * O, 0,
                                spec, scale, False, variant="staged")
        out = torch.empty((B, O), device="cuda")
        for name in names:
            def call(f=fns[name]["f32"]):
                err = f(x.data_ptr(), tabs.data_ptr(), out.data_ptr(), None,
                        B, G, O, group, spec.bits, spec.zero_point, scale,
                        V * O, 0, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(out, want))
            t = chip_smoke.time_calls(torch, [call] * 4, flush,
                                      "gemv_staged")
            print(f"staged {what:10s} B {B:4d} {name:12s} "
                  f"{t['ms']:9.4f} ms (warm {t['warm_ms']:9.4f})  equal to"
                  f" the committed staged design {same}", flush=True)
        del tabs, x
        torch.cuda.empty_cache()
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("gemv_split_sweep: no CUDA device")
        return 2
    if sys.argv[1:2] == ["x:rows"]:
        return rows_mode(sys.argv[2].split(",") if len(sys.argv) > 2
                         else list(ROW_SHAPES))
    if len(sys.argv) > 1 and sys.argv[1].startswith("st:"):
        return staged_mode(sys.argv[1].split(","))
    from repro_torch.core.quantization import QuantSpec, scale_from_amax
    from repro_torch.kernels import build, ops
    import chip_smoke

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    fns = build_variants(names, build)
    names = [n for n in names if n in fns]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    flush = chip_smoke.L2Flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    step = {(n, p): 0.0 for n in ["direct", *names] for p in (False, True)}
    for what, pw, bits, G, O, L, paired, counters, per_step in SHAPES:
        spec = QuantSpec(bits, True)
        V = 1 << (bits * pw)
        # segment-major [G, L, V, O] when paired (the layer by offset),
        # else layer-major [L, G, V, O]; random cells (the time does not
        # depend on them)
        tabs = torch.randn((G, L, V, O) if paired else (L, G, V, O),
                           generator=gen, device="cuda")
        seg_stride = L * V * O if paired else V * O
        xs = [torch.randn(B, G * pw, generator=gen, device="cuda")
              for _ in range(L)]
        scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec))
        out = torch.empty((B, O), device="cuda")
        stats = torch.zeros(2, dtype=torch.int32, device="cuda")

        def launch(f, l, variant, dst=out):
            off = l * V * O if paired else l * G * V * O
            err = f(xs[l].data_ptr(), tabs.data_ptr(), dst.data_ptr(),
                    stats.data_ptr(), B, G, O, pw, bits, spec.zero_point,
                    scale, seg_stride, off, int(counters), variant, stream)
            if err:
                raise RuntimeError(f"{what}: cudaError {err}")

        lib = build.library("gemv_stacked")
        committed = lib.pcilt_gemv_fused_f32
        ref = [torch.empty((B, O), device="cuda") for _ in range(L)]
        for l in range(L):
            launch(committed, l, 0, ref[l])
        split = ops.gemv_variant(B, G, O, 4)
        rows = {"direct": (committed, 1, chip_smoke.GEMV_DIRECT_KERNEL)}
        rows.update({n: (fns[n], 0, chip_smoke.GEMV_SPLIT_KERNEL)
                     for n in names})
        for name, (f, variant, kname) in rows.items():
            got = torch.empty((B, O), device="cuda")
            err = 0.0
            for l in range(L):
                launch(f, l, variant, got)
                torch.cuda.synchronize()
                err = max(err, float((got - ref[l]).abs().max()))
            tol = 1e-4 * float(torch.stack(ref).abs().max())
            calls = [lambda l=l: launch(f, l, variant)
                     for l in range(L)] * max(1, 32 // L)
            t = chip_smoke.time_calls(torch, calls, flush, kname)
            step[(name, paired)] += per_step * t["ms"]
            print(f"{what:20s} G{G:4d} O{O:5d} {name:10s} "
                  f"{t['ms'] * 1e3:8.2f} us (warm {t['warm_ms'] * 1e3:8.2f})"
                  f"  max|d| vs committed split {err:.3e} "
                  f"{'ok' if err <= tol else 'FAIL'}  split {tuple(split)}",
                  flush=True)
        del tabs, xs, ref
        torch.cuda.empty_cache()
    for (name, paired), ms in step.items():
        print(f"a decode step's 144 launches of kernel "
              f"{8 if paired else 1}: {name:10s} {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
