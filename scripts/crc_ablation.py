#!/usr/bin/env python3
"""The CRC-32 kernel's chunk passes with one stage removed, on the card.

    python3 scripts/crc_ablation.py [variant,variant,...]

Builds variants of ``src/repro_torch/kernels/csrc/pcilt_crc32.cu`` into
``build/sweep/``, each a text edit of the source as
``scripts/conv2d_ablation.py`` makes them, and times both chunk-pass
designs of each (``banked``, the default, and ``kept``) over one
full-width mamba2-130m layer's seven table streams (2.39 GB, as the
monitor's layer check makes them) beside the bytes bound at 3.35 TB/s.
What a removed stage saves says what sets a design's pace:

* ``base`` — the committed source (its CRCs are held to ``zlib.crc32``);
* ``nolookup`` — every table lookup replaced by a rotate of the word
  (the loads, the loop and the joins stay): the memory path's pace;
* ``noload`` — the banked design's staged loads replaced by synthetic
  words (the staging tile, the lookups and the joins stay): the compute's
  pace;
* ``unstaged`` — the banked design with every lane loading its own slice
  (the kept design's memory path; its lookups stay conflict-free).

Each time is profiler device time of whole calls (the chunk pass and its
combine passes) with L2 flushed before every call
(``chip_smoke.time_calls``).  The ablations' CRCs are wrong and marked so.
Prints one line per variant and design.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: the lookups of both designs replaced by a rotate of their word
NOLOOKUP = [
    ("  return tl[(3 * 256 + (x & 0xFFu)) * 32] ^\n"
     "         tl[(2 * 256 + ((x >> 8) & 0xFFu)) * 32] ^\n"
     "         tl[(256 + ((x >> 16) & 0xFFu)) * 32] ^ tl[(x >> 24) * 32];",
     "  return __funnelshift_l(x, x, 5);"),
    ("  const uint32_t a = v.x ^ c;\n  return T[15][a & 0xFFu]",
     "  const uint32_t a = v.x ^ c;\n"
     "  return __funnelshift_l(a, a, 5) ^ v.y ^ v.z ^ v.w;\n"
     "  return T[15][a & 0xFFu]")]
#: the banked design's staged loads replaced by synthetic words
NOLOAD = [
    ("        next[i] = __ldg(reinterpret_cast<const uint4*>(\n"
     "            src + (long long)(4 * i) * kLaneBytes));",
     "        next[i] = make_uint4(i, row, col, lane);"),
    ("            next[i] = __ldg(reinterpret_cast<const uint4*>(\n"
     "                src + (long long)(4 * i) * kLaneBytes +\n"
     "                (b + 1) * kRowBlock));",
     "            next[i] = make_uint4(b, i, crc, lane);")]
#: every chunk of the banked design folded lane by lane from its own loads
UNSTAGED = [("    if (cb != nullptr) {  // the same for every lane of the warp",
             "    if (false) {")]
VARIANTS = {"base": [], "nolookup": NOLOOKUP, "noload": NOLOAD,
            "unstaged": UNSTAGED}
#: which designs each variant changes (the others are not timed again)
CHANGES = {"base": ("banked", "kept"), "nolookup": ("banked", "kept"),
           "noload": ("banked",), "unstaged": ("banked",)}


def apply_edits(src, name):
    text = src
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the edit's anchor is not in "
                             f"the source once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(names, build):
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(csrc, "pcilt_crc32.cu")).read()
    procs = {}
    for name in names:
        cu = os.path.join(out_dir, f"crc_{name}.cu")
        with open(cu, "w") as f:
            f.write(apply_edits(src, name))
        lib = os.path.join(out_dir, f"libcrc_{name}.so")
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        f = ctypes.CDLL(lib)
        f.pcilt_crc32.argtypes = build._CONFIG_SIGNATURES["pcilt_crc32"]
        f.pcilt_crc32.restype = ctypes.c_int
        libs[name] = f
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("crc_ablation: no CUDA device")
        return 2
    from repro_torch.kernels import build, ops
    import chip_smoke

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    libs = build_variants(names, build)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    sizes = list(chip_smoke.LAYER_TABLES.values())
    nbytes = sum(sizes)
    buf = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                        generator=gen, device="cuda")
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    streams = [(buf, [a], n) for a, n in zip(starts, sizes)]
    want = ops.pcilt_crc32(streams)
    flush = chip_smoke.L2Flush(torch)
    bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3

    for name in names:
        if name not in libs:
            continue
        build._libs["crc32"] = libs[name]  # the wrapper launches the variant
        try:
            for design in CHANGES[name]:
                def call(design=design):
                    with ops._crc_forced(design):
                        return ops.pcilt_crc32(streams)

                got = call()
                t = chip_smoke.time_calls(torch, [call] * 5, flush,
                                          chip_smoke.CRC_KERNELS,
                                          launches_per_call=3)
                right = ("the committed library's CRCs" if got == want
                         else "other CRCs (ablated)")
                print(f"{name:9s} {design:7s} layer 2.39 GB  "
                      f"{t['ms']:8.3f} ms (warm {t['warm_ms']:8.3f})  "
                      f"bound {bound:6.3f} ms ({bound / t['ms']:.0%})  "
                      f"{right}", flush=True)
        finally:
            build._libs.pop("crc32", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
