#!/usr/bin/env python3
"""The fused GEMV's split design under other constants, on the card.

    python3 scripts/gemv_split_sweep.py [variant,variant,...]

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
    srcs = {f: open(os.path.join(csrc, f)).read()
            for f in ("pcilt_gemv_stacked.cu", "pcilt_split.cuh")}
    procs = {}
    for name in names:
        consts, edits = VARIANTS[name]
        texts = dict(srcs)
        for const, value in consts.items():
            hits = 0
            for f, text in texts.items():
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
        vdir = os.path.join(out_dir, name)  # the variant's header beside it
        os.makedirs(vdir, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        cu = os.path.join(vdir, "pcilt_gemv_stacked.cu")
        lib = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu]
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
        print(f"built {name}: {VARIANTS[name][0]} registers {regs} spills "
              f"{spills or 'none'}", flush=True)
        f = ctypes.CDLL(lib).pcilt_gemv_fused_f32
        f.argtypes = build._SIGNATURES["pcilt_gemv_fused"]
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("gemv_split_sweep: no CUDA device")
        return 2
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
