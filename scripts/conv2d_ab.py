#!/usr/bin/env python3
"""The staged conv kernels (kernels 4 and 5, and the host-packed 6 and 7)
of several checkouts, side by side on one card.

    python3 scripts/conv2d_ab.py TREE TREE ...

Each TREE is the root of a checkout (``.`` for this one; a parent unpacked
by ``git archive`` into ``build/``, which ``.gitignore`` lists).  For each,
in a subprocess of its own and in the order given (give ``parent change
change parent``), it builds that tree's kernel libraries, sets up the
paper CNN of that tree's ``chip_smoke.py`` (seeded weights, the seeded
1024x768 image), runs the dense fake-quant chain up to conv4's input, and
times conv4 (C 200, O 350) through the wrappers a user calls:
``pcilt_fused_conv2d`` (kernel 4) and ``pcilt_shared_conv2d`` on phase
4's shared pool (kernel 5, X 5000), each the staged design's code pre-pass
and fetch, then ``pcilt_gemv`` and ``pcilt_conv2d`` (kernels 6 and 7, the
staged design) on conv4's packed offsets, by CUDA events over 3 calls after
one warm-up.  It prints each tree's times, the sha256 of each output's
bytes (byte-equal across trees or not), and the registers and spills
``ptxas`` reported for each template instance of
``conv2d_staged_kernel``.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import hashlib, json, re, sys
tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke as cs
from repro_torch.core.lut_layers import flatten_filters
from repro_torch.core.pcilt import build_grouped_tables
from repro_torch.core.serving import convert_conv_kernel
from repro_torch.kernels import build, ops
from repro_torch.models.cnn import dm_conv2d

build.build_all()
instances = []
cur = None
for line in build.report("conv2d").splitlines():
    m = re.search(r"Compiling entry function '([^']+)'", line)
    if m:
        cur = m.group(1) if "conv2d_staged_kernel" in m.group(1) else None
        spill = (0, 0)
        continue
    if cur is None:
        continue
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
        spill = (int(m.group(1)), int(m.group(2)))
    m = re.search(r"Used (\d+) registers", line)
    if m:
        instances.append({"instance": cur, "registers": int(m.group(1)),
                          "spill_stores": spill[0], "spill_loads": spill[1]})
        cur = None
torch.backends.cudnn.allow_tf32 = False
model, params, scales, h = cs.paper_cnn_setup(torch)
spec, k = model.act_spec, model.k
last = len(model.channels) - 1


def mean_ms(call, n=3):
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


with torch.no_grad():
    for i in range(last):
        w, s = params[f"conv{i}"], scales[f"conv{i}"]
        h = torch.relu(dm_conv2d(h, w, spec, s))
    w, s = params[f"conv{last}"], scales[f"conv{last}"]
    tabs = build_grouped_tables(flatten_filters(w, 1), spec, s, 1)
    pool = convert_conv_kernel(w, spec, s, 1, weight_bits=4,
                               shared=True).shared
    xp = cs.padded(h, k, 1)
    fused = lambda: ops.pcilt_fused_conv2d(xp, tabs, spec, s, 1, k, k,
                                           padding="VALID")
    shared = lambda: ops.pcilt_shared_conv2d(
        xp, pool.pool, pool.seg_idx, spec, s, 1, k, k, padding="VALID")
    before = dict(ops.CONV_VARIANT_LAUNCHES)
    out = {"tree": tree, "conv4_ms": mean_ms(fused),
           "conv4_shared_ms": mean_ms(shared),
           "X": int(pool.pool.shape[0])}
    G = tabs.shape[0]
    off = cs.host_offsets(torch, xp, spec, s, k, G)
    gemv = lambda: ops.pcilt_gemv(off.view(-1, G), tabs)
    conv = lambda: ops.pcilt_conv2d(off, tabs)
    host_before = dict(ops.GEMV_HOST_VARIANT_LAUNCHES)
    out["conv4_gemv_host_ms"] = mean_ms(gemv)
    out["conv4_conv2d_host_ms"] = mean_ms(conv)
    out["host_designs"] = {d: c - host_before[d] for d, c in
                           ops.GEMV_HOST_VARIANT_LAUNCHES.items()}
    for name, run in (("conv4", fused), ("conv4_shared", shared),
                      ("conv4_gemv_host", gemv),
                      ("conv4_conv2d_host", conv)):
        y = run()
        torch.cuda.synchronize()
        out[name + "_sha256"] = hashlib.sha256(
            y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()
    out["designs"] = {d: c - before[d]
                      for d, c in ops.CONV_VARIANT_LAUNCHES.items()}
    out["staged_instances"] = instances
print("RESULT " + json.dumps(out), flush=True)
'''


def main():
    trees = sys.argv[1:]
    if not trees:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    results = []
    for tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree,
                              capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{tree}: the run failed")
        r = json.loads(line[-1][len("RESULT "):])
        results.append(r)
        spills = sorted({(x["registers"], x["spill_stores"],
                          x["spill_loads"]) for x in r["staged_instances"]})
        print(f"{tree}: conv4 {r['conv4_ms']:.3f} ms, conv4 shared (X "
              f"{r['X']}) {r['conv4_shared_ms']:.3f} ms, designs "
              f"{r['designs']}; kernel 6 {r['conv4_gemv_host_ms']:.3f} ms, "
              f"kernel 7 {r['conv4_conv2d_host_ms']:.3f} ms, designs "
              f"{r['host_designs']}; conv2d_staged_kernel (registers, spill "
              f"stores, spill loads) over its {len(r['staged_instances'])} "
              f"instances: {spills}", flush=True)
        for x in r["staged_instances"]:
            if x["spill_stores"] or x["spill_loads"]:
                print(f"  spills: {x}", flush=True)
    for name in ("conv4_sha256", "conv4_shared_sha256",
                 "conv4_gemv_host_sha256", "conv4_conv2d_host_sha256"):
        same = len({r[name] for r in results}) == 1
        print(f"{name}: {'byte-equal' if same else 'DIFFERENT'} across the "
              f"trees ({results[0][name][:16]}...)")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
