#!/usr/bin/env python3
"""Where the staged conv kernel's time goes, on the card.

    python3 scripts/conv2d_ablation.py [variant,variant,...]

Builds variants of ``src/repro_torch/kernels/csrc/pcilt_conv2d.cu``, each
with one stage of the staged fetch removed by a text edit of the source or
of the staged pieces it includes from ``pcilt_common.cuh`` (timing only:
every variant but ``base`` gives wrong sums), into ``build/ablation/<variant>/``, and times each variant's float32 fused kernel (the
fetch launch alone, on a code image made once) at every layer of the paper
CNN at 1024x768 on its real input (the dense fake-quant chain of the
seeded network, as ``chip_smoke.py`` phase 4), beside the kept design.
Prints, per layer, the mean over two back-to-back launches on CUDA events
and how many distinct codes one block (one output row) meets per segment.

Variants: ``base`` (the committed kernel), ``fetchonly`` (no slice
copies, no code loads, no offset packing: the fetch loop and the barrier),
``noload`` (no code loads), ``noissue`` (no slice copies), ``nomask``
(every slice row copied, not only the rows some pixel names).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

NO_LOAD = ("    load_codes<kG>(codes, pbase, walk, group, n, C, kw, HWp, Wp, "
         "raw_in,\n                   mask_in);", "")
NO_COPY = ("    issue(g + kAhead);\n", "    cp_async_commit();\n")
NO_PACK = ("    store_offsets<kG>(s_off + (gs % kOffRing) * kPixTile,",
         "    if (false) store_offsets<kG>(s_off + (gs % kOffRing) * "
         "kPixTile,")
VARIANTS = {"base": [],
            "fetchonly": [NO_LOAD, NO_COPY, NO_PACK],
            "noload": [NO_LOAD],
            "noissue": [NO_COPY],
            "nomask": [("use[i] = used[r0 + i * kPass] != 0;",
                        "use[i] = true;")]}


def build_variants(names, build):
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    files = ("pcilt_conv2d.cu", "pcilt_common.cuh")
    procs = {}
    for name in names:
        # each edit applies to the one file whose text holds its anchor; a
        # variant's directory holds both, so the source includes its header
        texts = {f: open(os.path.join(csrc, f)).read() for f in files}
        for old, new in VARIANTS[name]:
            hits = [f for f in files if texts[f].count(old) == 1]
            if len(hits) != 1 or any(texts[f].count(old) > 1 for f in files):
                raise SystemExit(f"variant {name}: the edit's anchor is not "
                                 f"in the sources once: {old!r}")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        out_dir = os.path.join(ROOT, "build", "ablation", name)
        os.makedirs(out_dir, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(out_dir, f), "w") as fh:
                fh.write(text)
        cu = os.path.join(out_dir, files[0])
        lib = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{text}")
        f = ctypes.CDLL(lib).pcilt_fused_conv2d_staged_f32
        f.argtypes = build._SIGNATURES["pcilt_fused_conv2d_staged"]
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("conv2d_ablation: no CUDA device")
        return 2
    from repro_torch.core.lut_layers import flatten_filters
    from repro_torch.core.pcilt import build_grouped_tables
    from repro_torch.kernels import build, ops
    from repro_torch.models.cnn import dm_conv2d
    import chip_smoke

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    fns = build_variants(names, build)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    model, params, scales, x = chip_smoke.paper_cnn_setup(torch)
    spec, k = model.act_spec, model.k
    H, W = chip_smoke.FULL_HW
    stream = torch.cuda.current_stream().cuda_stream

    def mean_ms(call, n=2):
        call()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            call()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / n

    h = x
    with torch.no_grad():
        for i, (C, O) in enumerate(chip_smoke.conv_layers(model)):
            w, s = params[f"conv{i}"], scales[f"conv{i}"]
            tabs = build_grouped_tables(flatten_filters(w, 1), spec, s, 1)
            G = tabs.shape[0]
            xp = chip_smoke.padded(h, k, 1)
            codes = ops._conv_codes(xp, spec, s)
            _, Hp, Wp, _ = xp.shape
            distinct = []
            for y in (100, 400, 700):  # one block = one output row
                rows = codes[0, :, y:y + k, :]
                m = torch.stack([rows[:, ti, tj:tj + W] for ti in range(k)
                                 for tj in range(k)]).reshape(-1, W)
                srt = m.sort(dim=1).values
                distinct.append(float(((srt[:, 1:] != srt[:, :-1]).sum(1)
                                       + 1).float().mean()))
            out = torch.empty((1, H, W, O), device="cuda")
            for name, f in fns.items():
                def call(f=f):
                    err = f(codes.data_ptr(), tabs.data_ptr(), None,
                            out.data_ptr(), 1, C, Hp, Wp, H, W, k, k, 1, G,
                            0, 256, O, 1, spec.bits, 0, G, 0, C, stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                print(f"conv{i} C{C} O{O} {name:9s} {mean_ms(call):9.2f} ms",
                      flush=True)
            kept = mean_ms(lambda: ops._fused_conv2d(
                xp, tabs, spec, s, 1, k, k, padding="VALID",
                variant="direct"), 1)
            print(f"conv{i} kept kernel {kept:9.2f} ms; distinct codes a "
                  f"block meets per segment (rows 100/400/700): "
                  f"{[round(d, 1) for d in distinct]}", flush=True)
            h = torch.relu(dm_conv2d(h, w, spec, s))
            del tabs, xp, codes, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
