#!/usr/bin/env python3
"""Kernels 3 and 12 (the shared-pool head GEMV and the host-packed dwconv)
under other constants and with a stage removed, on the card.

    python3 scripts/shared_dwconv_sweep.py [variant,variant,...]

Builds variants of ``src/repro_torch/kernels/csrc/pcilt_shared_gemv.cu``
(``s:`` names) and ``pcilt_dwconv1d.cu`` (``d:`` names), each with other
values of the new design's constants (a text edit of their ``constexpr``
lines) or a stage removed (a text edit of the source), into
``build/sweep/``, and times each variant's new design beside the
committed library's kept one ("direct", forced):

* kernel 3 at mamba2-130m's logits head — a [384, 256, 50288] pool of
  random cells, one pool row a segment, 4-bit group-2 offsets of a seeded
  [B, 768] input — at B = 4 and B = 1 in float32 and at B = 4 in bfloat16,
  beside ``torch.matmul`` of the dense [768, 50288] weights;
* kernel 12 at the single-layer signal's offsets ([4, 2048, 1792], V 256,
  2-bit, 4 taps) in float32 and bfloat16, beside ``torch.take``.

Each time is profiler device time with L2 flushed before every call
(``chip_smoke.time_calls``), beside the bound: the distinct pool rows (or
table cells) this run's offsets fetch, the input read once and the output
written once, at 3.35 TB/s.  The committed library's new design is held to
its plain version first (kernel 3 bit-equal to the plain version summed in
the split's order, kernel 12 exact, out-of-range offsets giving 0); each
variant's output to the committed one (bit-equal, or within 1e-4 of the
largest output when its split differs).  The ablations (marked
``timing only``) give wrong sums.

Variants: ``s:base`` and ``d:base`` (the committed sources) and the names in
``VARIANTS`` below.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SHARED_SRC, DW_SRC = "pcilt_shared_gemv.cu", "pcilt_dwconv1d.cu"
#: kernel 3's stages, removed one at a time (timing only): ``nofetch``
#: loads no pool cell, ``noquant`` packs offsets from a synthetic value (no
#: activation loads, no division), ``noreduce`` skips the cluster's
#: reduction (no cluster barrier, no distributed shared memory)
S_NOFETCH = ("if (row[u][r] >= 0 && c + k * VEC < O)", "if (false)")
S_NOQUANT = ("o |= pcilt::quantize_code(xs[j], scale, zp, kmax, &sat)\n",
             "o |= ((g * 7 + r * 3 + j) & kmax)\n")
S_NOREDUCE = [("    cluster.sync();\n    const int E", "    const int E"),
              ("        if (q < sp.cluster) peer[q] = cluster.map_shared_rank("
               "part, q)[e];", "        peer[q] = part[e];"),
              ("    cluster.sync();  // no block leaves, or overwrites its "
               "sums, while read", "")]
S_LDCS = ("v[u][r][k] = __ldg(", "v[u][r][k] = __ldcs(")
#: a block always holds 4 batch rows (at B = 1, 3 of them idle)
S_ROWS4 = ("s.rows = B >= 3 ? kRows : B;", "s.rows = kRows;")
#: kernel 12's (timing only but ``narrow``, ``ldcs``): ``nostage`` stages
#: no table slice, ``nogather`` reads no slice cell (a copy of the
#: offsets), ``nopipe`` loads no offsets past the first batch, ``narrow``
#: gives a lane one channel and 4-byte accesses, ``ldcs`` loads the
#: offsets evict-first instead of through the read-only path
D_NOSTAGE = ("const int nch = min(kDwChans, C - c0);", "const int nch = 0;")
D_NOGATHER = ("? pcilt::to_f32(s_tab[(cl + k) * V + off])", "? (float)off")
D_NOPIPE = ("    load(nx, r + RP * U);\n", "")
D_NARROW = ("const bool wide = C % 4 == 0 &&", "const bool wide = false &&")
D_LDCS = [("o[0] = __ldg(p);", "o[0] = __ldcs(p);"),
          ("const int4 v = __ldg(", "const int4 v = __ldcs(")]
#: name -> (source, constants, edits, sums right)
VARIANTS = {
    "s:base": (SHARED_SRC, {}, [], True),
    "s:warps4": (SHARED_SRC, {"kWarps": 4}, [], True),
    "s:warps16": (SHARED_SRC, {"kWarps": 16}, [], True),
    "s:loads4": (SHARED_SRC, {"kLoads": 4}, [], True),
    "s:loads16": (SHARED_SRC, {"kLoads": 16}, [], True),
    "s:target264": (SHARED_SRC, {"kTargetBlocks": 264}, [], True),
    "s:target66": (SHARED_SRC, {"kTargetBlocks": 66}, [], True),
    "s:ldcs": (SHARED_SRC, {}, [S_LDCS], True),
    "s:rows4": (SHARED_SRC, {}, [S_ROWS4], True),
    "s:nofetch": (SHARED_SRC, {}, [S_NOFETCH], False),
    "s:noquant": (SHARED_SRC, {}, [S_NOQUANT], False),
    "s:noreduce": (SHARED_SRC, {}, S_NOREDUCE, False),
    "d:base": (DW_SRC, {}, [], True),
    "d:chans64": (DW_SRC, {"kDwChans": 64}, [], True),
    "d:chans128": (DW_SRC, {"kDwChans": 128, "kDwTargetBlocks": 132}, [],
                   True),
    "d:threads512": (DW_SRC, {"kDwThreads": 512, "kDwTargetBlocks": 264},
                     [], True),
    "d:unroll1": (DW_SRC, {"kDwUnroll": 1}, [], True),
    "d:unroll4": (DW_SRC, {"kDwUnroll": 4}, [], True),
    "d:target264": (DW_SRC, {"kDwTargetBlocks": 264}, [], True),
    "d:narrow": (DW_SRC, {}, [D_NARROW], True),
    "d:ldcs": (DW_SRC, {}, D_LDCS, True),
    "d:nostage": (DW_SRC, {}, [D_NOSTAGE], False),
    "d:nogather": (DW_SRC, {}, [D_NOGATHER], False),
    "d:nopipe": (DW_SRC, {}, [D_NOPIPE], False),
}
#: the yardstick of what this card streams: one pass over contiguous bytes
#: with 16-byte loads (and stores), 8 in flight a thread, 8 blocks an SM
PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void stream_probe_kernel(const uint4* __restrict__ p,
                                    uint4* __restrict__ q, long long n,
                                    unsigned* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (; i + 7 * stride < n; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __ldcs(p + i + u * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (q) __stcs(q + i + u * stride, v[u]);
      acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
  }
  for (; i < n; i += stride) {
    const uint4 v = __ldcs(p + i);
    if (q) __stcs(q + i, v);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;
}
extern "C" int stream_probe(const void* p, void* q, long long n16,
                            void* out, int blocks, void* stream) {
  stream_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, (uint4*)q, n16, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""
SPLIT_KERNEL, SHARED_DIRECT = "shared_split_kernel", "shared_gemv_kernel"
STAGED_KERNEL, DW_DIRECT = "dwconv1d_staged_kernel", "dwconv1d_host_kernel"
#: the head: segments, columns; the signal: rows B*T, channels, taps
HEAD_G, HEAD_O = 384, 50288
SIG_B, SIG_T, SIG_C, SIG_K = 4, 2048, 1792, 4


def build_variants(names, build):
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
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
    cu = os.path.join(out_dir, "probe.cu")
    with open(cu, "w") as f:
        f.write(PROBE_CU)
    lib = os.path.join(out_dir, "lib_probe.so")
    procs["probe"] = (subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        if name == "probe":
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"the stream probe did not build:\n{text}")
            f = ctypes.CDLL(lib).stream_probe
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
            f.restype = ctypes.c_int
            libs[name] = f
            continue
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
                regs.append(f"{fn[:60]}: {line.split(':')[-1].strip()}")
        print(f"built {name}: {VARIANTS[name][1]}\n  " + "\n  ".join(regs),
              flush=True)
        cdll = ctypes.CDLL(lib)
        sym = "pcilt_shared_gemv" if name.startswith("s:") \
            else "pcilt_dwconv1d_host"
        for dt in ("f32", "bf16"):
            f = getattr(cdll, f"{sym}_{dt}")
            f.argtypes = build._SIGNATURES[sym]
            f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("shared_dwconv_sweep: no CUDA device")
        return 2
    import chip_smoke
    from repro_torch.core.offsets import pack_offsets
    from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                               quantize, scale_from_amax)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import pcilt_dwconv1d_ref

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    build.build_all()
    libs = build_variants(names, build)
    probe = libs.pop("probe")
    names = [n for n in names if n in libs]
    sink = None  # the probe's one output word
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = chip_smoke.L2Flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    dts = {torch.float32: "f32", torch.bfloat16: "bf16"}
    bad = []

    def timed(calls, kernel=None):
        return chip_smoke.time_calls(torch, calls, flush, kernel)["ms"]

    def stream_rate(what, nbytes, copy):
        """The probe over ``nbytes`` read (and as many written)."""
        nonlocal sink
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        src = torch.ones(int(nbytes) // 16 * 4, device="cuda")
        dst = torch.empty_like(src) if copy else None
        blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count

        def run():
            err = probe(src.data_ptr(), None if dst is None else
                        dst.data_ptr(), src.numel() // 4, sink.data_ptr(),
                        blocks, stream)
            if err:
                raise RuntimeError(f"stream probe: cudaError {err}")

        ms = timed([run] * 4, "stream_probe_kernel")
        label = "stream copy" if copy else "stream read"
        print(f"{what:26s} {label:14s} {ms * 1e3:9.2f} us  ("
              f"{nbytes * (2 if copy else 1) / ms / 1e9:.3f} TB/s: the probe "
              f"over {nbytes / 1e6:.1f} MB, contiguous)", flush=True)

    def report(what, name, ms, bound, err, tol, right):
        ok = err <= tol if right else True
        if not ok:
            bad.append((what, name))
        print(f"{what:26s} {name:14s} {ms * 1e3:9.2f} us  bound "
              f"{bound * 1e3:7.2f} us ({100 * bound / ms:5.1f}%)  max|d| "
              f"{err:.3e} {'ok' if ok else 'FAIL'}"
              f"{'' if right else ' (timing only)'}", flush=True)

    # -- kernel 3 at the head: the pool once in float32, once in bfloat16
    spec, group = QuantSpec(4, True), 2
    idx = torch.arange(HEAD_G, dtype=torch.int32, device="cuda")
    w = torch.randn(HEAD_G * group, HEAD_O, generator=gen, device="cuda") \
        * 0.05
    for dt in (torch.float32, torch.bfloat16):
        pool = torch.empty((HEAD_G, 256, HEAD_O), dtype=dt, device="cuda")
        for p in range(HEAD_G):
            pool[p].normal_(0.0, 0.05, generator=gen)
        for rows in ((4, 1) if dt == torch.float32 else (4,)):
            xs = [torch.randn(rows, HEAD_G * group, generator=gen,
                              device="cuda") for _ in range(4)]
            scale = float(scale_from_amax(0.8 * xs[0].abs().max(), spec))
            uniq = 0
            for x in xs:
                o = pack_offsets(quantize(x, spec, scale), 4, group)
                uniq += len(torch.unique(idx.long()[None] * 256 + o.long()))
            nbytes = (uniq / len(xs) * HEAD_O * pool.element_size()
                      + xs[0].numel() * 4 + HEAD_G * 4
                      + rows * HEAD_O * pool.element_size())
            bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            what = f"head B{rows} {dts[dt]}"
            out = torch.empty((rows, HEAD_O), dtype=dt, device="cuda")

            def launch(f, x, variant, dst=out):
                err = f(x.data_ptr(), idx.data_ptr(), pool.data_ptr(),
                        dst.data_ptr(), rows, HEAD_G, HEAD_G, 256, HEAD_O,
                        group, 4, spec.zero_point, scale, variant, stream)
                if err:
                    raise RuntimeError(f"{what}: cudaError {err}")

            committed = getattr(build.library("shared_gemv"),
                                f"pcilt_shared_gemv_{dts[dt]}")
            ref = [torch.empty_like(out) for _ in xs]
            for x, r in zip(xs, ref):
                launch(committed, x, 0, r)
            want = ops.shared_gemv_plain(xs[0], pool, idx, spec, scale,
                                         group, split_order=True)
            torch.cuda.synchronize()
            e0 = float((ref[0].float() - want.float()).abs().max())
            print(f"{what}: committed split vs its plain version in the "
                  f"split's order: max|d| {e0:.3e} "
                  f"{'bit-equal' if torch.equal(ref[0], want) else 'FAIL'}",
                  flush=True)
            if not torch.equal(ref[0], want):
                bad.append((what, "plain"))
            stream_rate(what, nbytes, False)
            if dt == torch.float32:
                dense = torch.randn(HEAD_G * group, HEAD_O, generator=gen,
                                    device="cuda")
                xq = [fake_quant(x, spec, scale) for x in xs]
                lib_ms = timed([lambda q=q: torch.matmul(q, dense)
                                for q in xq] * 4)
                print(f"{what:26s} {'matmul':14s} {lib_ms * 1e3:9.2f} us",
                      flush=True)
                del dense
            tol = 1e-4 * float(torch.stack(ref).float().abs().max())
            if dt == torch.bfloat16:
                tol = 1e-2 * float(torch.stack(ref).float().abs().max())
            rows_of = {"direct": (committed, 1, SHARED_DIRECT, True)}
            rows_of.update({n: (getattr(libs[n], f"pcilt_shared_gemv_"
                                                 f"{dts[dt]}"), 0,
                                SPLIT_KERNEL, VARIANTS[n][3])
                            for n in names if n.startswith("s:")})
            for name, (f, variant, kname, right) in rows_of.items():
                got = torch.empty_like(out)
                err = 0.0
                for x, r in zip(xs, ref):
                    launch(f, x, variant, got)
                    torch.cuda.synchronize()
                    err = max(err, float((got.float() - r.float()).abs()
                                         .max()))
                ms = timed([lambda x=x: launch(f, x, variant)
                            for x in xs] * 4, kname)
                report(what, name, ms, bound, err, tol, right)
        del pool
        torch.cuda.empty_cache()
    del w

    # -- kernel 12 at the signal's offsets
    spec2 = QuantSpec(2, True)
    V = 1 << (spec2.bits * SIG_K)
    x = torch.randn(SIG_B, SIG_T + SIG_K - 1, SIG_C, generator=gen,
                    device="cuda")
    codes = quantize(x, spec2, float(scale_from_amax(x.abs().max(),
                                                     spec2))).int()
    off = sum(codes[:, j:j + SIG_T] << (spec2.bits * j)
              for j in range(SIG_K)).contiguous()
    del x, codes
    bad_off = off.clone()
    bad_off[0, 0, :5] = torch.tensor([-1, V, V + 7, -100, 3])
    M = SIG_B * SIG_T
    for dt in (torch.float32, torch.bfloat16):
        tabs = torch.randn(SIG_C, V, generator=gen, device="cuda").to(dt)
        flat = (torch.arange(SIG_C, device="cuda") * V + off.long())
        cells = len(torch.unique(flat))
        es = tabs.element_size()
        bound = (cells * es + off.numel() * 4 + off.numel() * es) \
            / chip_smoke.HBM_BYTES_PER_S * 1e3
        what = f"dwconv signal {dts[dt]}"
        out = torch.empty(off.shape, dtype=dt, device="cuda")

        def launch(f, variant, src=off, dst=out):
            err = f(src.data_ptr(), tabs.data_ptr(), dst.data_ptr(),
                    src.numel(), SIG_C, V, variant, stream)
            if err:
                raise RuntimeError(f"{what}: cudaError {err}")

        committed = getattr(build.library("dwconv1d"),
                            f"pcilt_dwconv1d_host_{dts[dt]}")
        for src, label in ((off, "offsets"), (bad_off, "offsets out of "
                                                        "range")):
            got = torch.empty_like(out)
            launch(committed, 0, src, got)
            want = pcilt_dwconv1d_ref(src, tabs)
            torch.cuda.synchronize()
            ok = torch.equal(got, want) and (
                src is off or float(got[0, 0, :4].abs().max()) == 0.0)
            print(f"{what}: committed staged vs plain on the {label}: "
                  f"{'exact' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append((what, label))
        flat_t = tabs.reshape(-1)
        lib_ms = timed([lambda: torch.take(flat_t, flat)] * 4)
        print(f"{what:26s} {'torch.take':14s} {lib_ms * 1e3:9.2f} us",
              flush=True)
        stream_rate(what, off.numel() * 4, True)
        ref = torch.empty_like(out)
        launch(committed, 0, off, ref)
        rows_of = {"direct": (committed, 1, DW_DIRECT, True)}
        rows_of.update({n: (getattr(libs[n], f"pcilt_dwconv1d_host_"
                                             f"{dts[dt]}"), 0,
                            STAGED_KERNEL, VARIANTS[n][3])
                        for n in names if n.startswith("d:")})
        for name, (f, variant, kname, right) in rows_of.items():
            got = torch.empty_like(out)
            launch(f, variant, off, got)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            ms = timed([lambda: launch(f, variant)] * 4, kname)
            report(what, name, ms, bound, err, 0.0, right)
        del tabs, flat, out, ref
        torch.cuda.empty_cache()
    print(f"M {M}: tiling {tuple(ops.dwconv_host_tiling(M, SIG_C, V, 4))}; head"
          f" split {tuple(ops.shared_gemv_variant(4, HEAD_G, HEAD_O, 4))}",
          flush=True)
    if bad:
        print(f"FAILED: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
