"""The dry run: every (arch × shape × mesh) cell laid out on meta tensors
(port of ``repro.launch.dryrun``).

For each cell this driver

1. builds the production mesh over ``meta`` devices (``(16, 16)``, or
   ``(2, 16, 16)`` with ``--multi-pod``: 256 or 512 coordinates),
2. lays the step's inputs out on it (``launch.specs.input_specs``, then
   ``step_args``: a ``Placed`` of meta blocks a leaf; nothing allocated),
3. runs the port's own ``make_{train,prefill,decode}_step`` on them under
   the per-coordinate operation analysis (``launch.op_analysis``): flops,
   the bytes every operation reads and writes, each coordinate's live
   bytes and the moves between coordinates by kind,
4. writes one JSON a cell to ``experiments/dryrun_torch/<cell>.json``.

This is the counterpart of the reference lowering and compiling on a CPU
host: no step runs on the CPU in its place, and no device is touched.
``python -m repro_torch.launch.dryrun --all`` runs the whole grid;
failures are recorded (``status="error"``) and make the exit code 1.

A cell keeps the reference's keys where they have a meaning here
(``status``, ``n_chips``, ``memory``, ``cost``, ``collectives``,
``collective_bytes_per_device``, ``top_collectives``, ``top_buffers``,
``model_flops_global``, ``n_active_params``); each per-device number is
the busiest coordinate's.  ``memory``: ``argument_bytes`` (the placed
arguments' blocks a coordinate holds, ``nn.module.device_bytes``; a whole
batch tensor at the mesh's first coordinate, where the port's step takes
it), ``output_bytes`` alike over the outputs, ``alias_bytes`` (the outputs
that share storage with a donated argument: the parameters, optimizer
state and cache, as the reference donates them), ``temp_bytes`` (the peak
of live operation outputs, the step's own outputs among them) and
``total_nonalias_bytes`` (``argument_bytes + temp_bytes`` of one
coordinate).  ``trace_s`` (the seconds of the analysed run) replaces the
reference's ``lower_s``/``compile_s``; ``host_rss_mb`` is the process's
peak resident memory so far.  The reference's ``cost_raw``
(XLA's native numbers, a loop body counted once) has no counterpart: every
layer runs here, so ``cost`` is the only count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.interop import tree_leaves
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analysis
from repro_torch.launch.specs import data_spec, input_specs, step_args
from repro_torch.launch.steps import (active_matmul_params, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.nn import coords
from repro_torch.nn.module import Placed, device_bytes, shardings
from repro_torch.optim import AdamWConfig, cosine_schedule

__all__ = ["VARIANTS", "run_cell", "cell_path", "measure_cell",
           "measure_step", "summarize", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the reference's hill-climbing variants; a baseline cell has no suffix
VARIANTS = {
    "base": {},
    # bf16 gradient reductions; with half the microbatch re-gathers
    "bf16grads": {"bf16_grads": True},
    "llama4opt": {"bf16_grads": True, "grad_accum": 2},
    # ZeRO-1: parameters model-sharded only, moments sharded over data
    "zero1": {"bf16_grads": True, "zero1": True,
              "rule_overrides": {"embed": None,
                                 "opt_embed": ("data", "pod")}},
    # decode: the KV cache's time axis over the model axis, q-heads
    # replicated
    "kvshard": {"rule_overrides": {"cache_seq": "model", "heads": None}},
    # the time-sharded cache only
    "kvshard2": {"rule_overrides": {"cache_seq": "model"}},
    # ZeRO-1 with the gradients re-placed onto the moments' layout
    "zero1b": {"bf16_grads": True, "zero1": True, "pin_grads": True,
               "rule_overrides": {"embed": None,
                                  "opt_embed": ("data", "pod")}},
    # the blocks' row-parallel wo / wd through row_parallel
    "rowrs": {"explicit_rs": True},
    "llama4opt2": {"explicit_rs": True, "grad_accum": 2},
    "llama4opt3": {"explicit_rs": True, "grad_accum": 1},
}


def _skip_reason(cfg, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k-token decode KV is the quadratic "
                "regime the assignment skips (DESIGN.md §7)")
    return None


def _coord_bytes(tree, mesh) -> Dict[tuple, int]:
    """Bytes each coordinate holds of a step's arguments or outputs: the
    placed leaves' blocks, and any other tensor at the mesh's first
    coordinate (None: one device, the coordinate ``()``)."""
    first = mesh.coords[0] if mesh is not None else ()
    out = dict(device_bytes(tree)) if mesh is not None else {}
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            out[first] = out.get(first, 0) + leaf.numel() * \
                leaf.element_size()
    return out


def _storages(tree) -> Dict[int, int]:
    out = {}
    for leaf in tree_leaves(tree):
        ts = [t for _, t in leaf.unique()] if isinstance(leaf, Placed) else \
            [leaf] if torch.is_tensor(leaf) else []
        for t in ts:
            out[t.untyped_storage()._cdata] = 1
    return out


def _alias_bytes(outputs, donated, mesh) -> Dict[tuple, int]:
    keys = _storages(donated)
    first = mesh.coords[0] if mesh is not None else ()
    out: Dict[tuple, int] = {}
    for leaf in tree_leaves(outputs):
        if isinstance(leaf, Placed):
            for c, t in leaf.blocks.items():
                if t.untyped_storage()._cdata in keys:
                    out[c] = out.get(c, 0) + t.numel() * t.element_size()
        elif torch.is_tensor(leaf) and \
                leaf.untyped_storage()._cdata in keys:
            out[first] = out.get(first, 0) + leaf.numel() * \
                leaf.element_size()
    return out


def make_step(cfg, kind: str, mesh, variant: str = "base"):
    """The port's step of ``kind`` for ``cfg`` on ``mesh`` under
    ``variant`` (``VARIANTS``); ``cfg.grad_accum`` as the variant sets
    it."""
    v = VARIANTS[variant]
    ro = v.get("rule_overrides")
    if kind == "train":
        ocfg = AdamWConfig(lr=cosine_schedule(3e-4, 100, 10000),
                           quantize_moments=cfg.name.startswith("llama4"))
        grad_sh = None
        if v.get("pin_grads") and mesh is not None:
            def remap(s):
                if isinstance(s, dict):
                    return {k: remap(x) for k, x in s.items()}
                return dataclasses.replace(s, axes=tuple(
                    "opt_embed" if a == "embed" else a for a in s.axes))
            grad_sh = shardings(remap(build_model(cfg).param_specs()), mesh,
                                data_spec(mesh, ro))
        return make_train_step(cfg, mesh, ocfg,
                               bf16_grads=v.get("bf16_grads", False),
                               rule_overrides=ro, grad_shardings=grad_sh,
                               explicit_rs=v.get("explicit_rs", False))
    if kind == "prefill":
        return make_prefill_step(cfg, mesh, rule_overrides=ro)
    return make_decode_step(cfg, mesh, rule_overrides=ro)


_NUMERIC = ("argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
            "flops", "bytes_traffic_est", "collective_bytes")


def _key(c) -> str:
    return ",".join(str(i) for i in c) if c else "-"


def measure_step(step, kind: str, args: Dict, mesh) -> Dict:
    """Run ``step`` of ``kind`` once on ``args`` (``{params, opt_state,
    batch}``, ``{params, batch}`` or ``{params, cache, tokens}``; meta or
    real) under the operation analysis.  Returns the cell's numbers
    (:func:`summarize`) and, under ``"per_coord"``, each coordinate's:
    ``argument_bytes``, ``output_bytes``, ``alias_bytes``, ``temp_bytes``,
    ``total_nonalias_bytes``, ``flops``, ``bytes_traffic_est``,
    ``collective_bytes`` and ``coll`` (the moves by kind)."""
    if kind == "train":
        call = (args["params"], args["opt_state"], args["batch"])
        donated = (args["params"], args["opt_state"])
    elif kind == "prefill":
        call = (args["params"], args["batch"])
        donated = ()
    else:
        call = (args["params"], args["cache"], args["tokens"])
        donated = (args["cache"],)
    t0 = time.time()
    with torch.set_grad_enabled(kind == "train"), \
            analysis(mesh, call) as a:
        outputs = step(*call)
    trace_s = time.time() - t0
    rep = a.report()
    arg_b = _coord_bytes(call, mesh)
    out_b = _coord_bytes(outputs[:2] if kind == "train" else outputs, mesh)
    alias_b = _alias_bytes(outputs, donated, mesh)
    per = {}
    for key, pc in rep["per_coord"].items():
        c = tuple(int(i) for i in key.split(",")) if key != "-" else ()
        per[key] = {"argument_bytes": arg_b.get(c, 0),
                    "output_bytes": out_b.get(c, 0),
                    "alias_bytes": alias_b.get(c, 0),
                    "temp_bytes": pc["peak_live_bytes"],
                    "flops": pc["flops"],
                    "bytes_traffic_est": pc["bytes_traffic_est"],
                    "collective_bytes": pc["collective_bytes"],
                    "coll": pc["coll"]}
    zero = {k: {"count": 0, "bytes": 0} for k in coords.KINDS}
    for c, n in arg_b.items():  # a coordinate that ran nothing
        per.setdefault(_key(c), dict(
            dict.fromkeys(_NUMERIC, 0), argument_bytes=n, coll=zero))
    for v in per.values():
        v["total_nonalias_bytes"] = v["argument_bytes"] + v["temp_bytes"]
    return dict(summarize(per), trace_s=round(trace_s, 2),
                top_collectives=rep["top_collectives"],
                top_buffers=rep["top_buffers"], n_ops=rep["n_ops"],
                n_moves=rep["n_moves"], crossed=rep["crossed"],
                per_coord=per)


def summarize(per: Dict) -> Dict:
    """The cell's per-device numbers from each coordinate's: each the
    busiest coordinate's (``busiest`` names them)."""
    def most(key):
        return max(per, key=lambda c: per[c][key])

    mem = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
           "total_nonalias_bytes")
    cc = most("collective_bytes")
    return {
        "memory": {k: per[most(k)][k] for k in mem},
        "cost": {"flops_per_device": per[most("flops")]["flops"],
                 "bytes_traffic_est_per_device":
                     per[most("bytes_traffic_est")]["bytes_traffic_est"]},
        "collectives": per[cc]["coll"],
        "collective_bytes_per_device": per[cc]["collective_bytes"],
        "busiest": {k: most(k) for k in ("total_nonalias_bytes", "flops",
                                         "bytes_traffic_est",
                                         "collective_bytes")},
    }


def _extrapolate(a: Dict, b: Dict, k: int, args_bytes: Dict) -> Dict:
    """Each coordinate's numbers at the full depth from two probes whose
    depths differ by one step ``(b - a)``, taken ``k`` more steps: ``a +
    k (b - a)``; the argument bytes are the full depth's own, the peak of
    live bytes the deeper probe's (a peak is not a sum of layers)."""
    per = {}
    for c in a:
        pa, pb = a[c], b[c]
        v = {key: pa[key] + k * (pb[key] - pa[key]) for key in _NUMERIC}
        v["temp_bytes"] = pb["temp_bytes"]
        v["coll"] = {kd: {f: pa["coll"][kd][f] + k * (pb["coll"][kd][f]
                                                     - pa["coll"][kd][f])
                          for f in ("count", "bytes")}
                     for kd in pa["coll"]}
        v["argument_bytes"] = args_bytes.get(c, 0)
        v["total_nonalias_bytes"] = v["argument_bytes"] + v["temp_bytes"]
        per[c] = v
    return per


def measure_cell(cfg, shape_name: str, mesh, variant: str = "base",
                 depths: Optional[Tuple[int, int]] = None) -> Dict:
    """The numbers of one cell of ``cfg`` on ``mesh`` (meta: no device is
    touched).  With ``depths=(d1, d2)`` the step runs at ``d1`` and ``d2``
    layers (the same widths) instead of ``cfg.n_layers``, and each
    coordinate's numbers are carried to the full depth along the line
    through the two (``n_layers - d1`` a multiple of ``d2 - d1``): exact
    for flops, moves and outputs, whose every layer adds the same, and for
    a forward step's traffic; a train step's traffic so carried is an
    estimate.  ``temp_bytes`` (and so ``total_nonalias_bytes``) is the
    ``d2``-layer run's: a floor of the full depth's, not carried.  The
    cell's ``depth`` lists which is which.  The argument bytes are the
    full depth's either way."""
    v = VARIANTS[variant]
    sh = SHAPES[shape_name]

    def one(c):
        specs = input_specs(c.name, shape_name, mesh, cfg=c,
                            rule_overrides=v.get("rule_overrides"),
                            zero1=v.get("zero1", False))
        args = step_args(specs)
        if sh.kind == "decode":  # a filled cache: the next write its last
            args["cache"]["pos"] = sh.seq_len - 1
        return args

    if depths is None:
        return measure_step(make_step(cfg, sh.kind, mesh, variant), sh.kind,
                            one(cfg), mesh)
    d1, d2 = depths
    L = cfg.n_layers
    if d2 <= d1 or (L - d1) % (d2 - d1):
        raise ValueError(f"depths {depths} do not step to {L} layers")
    runs = []
    for d in depths:
        c = dataclasses.replace(cfg, n_layers=d)
        runs.append(measure_step(make_step(c, sh.kind, mesh, variant),
                                 sh.kind, one(c), mesh))
    full = one(cfg)
    kind_args = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "cache", "tokens")}[sh.kind]
    arg_b = {_key(c): n for c, n in _coord_bytes(
        tuple(full[k] for k in kind_args), mesh).items()}
    per = _extrapolate(runs[0]["per_coord"], runs[1]["per_coord"],
                       (L - d1) // (d2 - d1), arg_b)
    # a train step's gradient of a stacked leaf is made whole at every
    # layer (``select``'s backward), so its traffic grows as the square
    exact = ["argument_bytes", "flops", "collective_bytes", "collectives",
             "output_bytes", "alias_bytes"]
    estimated = ["bytes_traffic_est"] if sh.kind == "train" else []
    if sh.kind != "train":
        exact.append("bytes_traffic_est")
    last = runs[1]
    return dict(summarize(per),
                trace_s=round(sum(r["trace_s"] for r in runs), 2),
                top_collectives=last["top_collectives"],
                top_buffers=last["top_buffers"],
                n_ops=sum(r["n_ops"] for r in runs),
                n_moves=sum(r["n_moves"] for r in runs),
                crossed=sum(r["crossed"] for r in runs), per_coord=per,
                depth={"run": list(depths), "full": L, "exact": exact,
                       "estimated": estimated,
                       "at_cut_depth": ["temp_bytes", "total_nonalias_bytes",
                                        "top_buffers", "top_collectives"],
                       "cut_depth": d2})


def run_cell(arch: str, shape_name: str, multi_pod: bool, cfg=None,
             variant: str = "base", *,
             depths: Optional[Tuple[int, int]] = None) -> Dict:
    """One cell on the meta production mesh (module docstring); a failure
    is recorded as ``status="error"``.  The coordinates' numbers are kept
    as their spread (the least and most of each); ``depths`` runs two cut
    depths and carries them to the full one (:func:`measure_cell`)."""
    v = VARIANTS[variant]
    cfg = cfg or get_config(arch)
    if "grad_accum" in v:
        cfg = dataclasses.replace(cfg, grad_accum=v["grad_accum"])
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "variant": variant, "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    reason = _skip_reason(cfg, shape_name)
    if reason:
        cell.update(status="skipped", reason=reason)
        return cell
    sh = SHAPES[shape_name]
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * n)
    try:
        res = measure_cell(cfg, shape_name, mesh, variant, depths)
        per = res.pop("per_coord")
        res["busiest"] = {k: _key(c) if isinstance(c, tuple) else c
                          for k, c in res["busiest"].items()}
        keys = ("argument_bytes", "temp_bytes", "total_nonalias_bytes",
                "flops", "bytes_traffic_est", "collective_bytes")
        res["spread"] = {k: [min(p[k] for p in per.values()),
                             max(p[k] for p in per.values())] for k in keys}
        n_active = active_matmul_params(cfg)
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        cell.update(status="ok", n_chips=int(mesh.devices.size), **res,
                    model_flops_global=(6 if sh.kind == "train" else 2)
                    * n_active * tokens,
                    n_active_params=n_active,
                    host_rss_mb=resource.getrusage(
                        resource.RUSAGE_SELF).ru_maxrss / 1024)
    except Exception as e:  # noqa: BLE001 — recorded: it is a bug
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])
    return cell


def cell_path(arch: str, shape_name: str, mesh_name: str,
              variant: str = "base") -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    safe = arch.replace("/", "_").replace(".", "_")
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(OUT_DIR,
                        f"{safe}__{shape_name}__{mesh_name}{suffix}.json")


def main(*, argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--force", action="store_true", help="ignore cache")
    p.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    p.add_argument("--depths", default=None, metavar="D1,D2",
                   help="run two cut depths and carry the numbers to the "
                        "full depth (flops and moves exact; the peak of "
                        "live bytes the deeper run's)")
    args = p.parse_args(argv)
    depths = tuple(int(d) for d in args.depths.split(",")) \
        if args.depths else None

    archs = ARCHS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if (args.both_meshes or args.all) \
        else (args.multi_pod,)

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                path = cell_path(arch, shape_name, mesh_name, args.variant)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        cell = json.load(f)
                    if cell.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {shape_name} {mesh_name}: "
                              f"{cell['status']}")
                        n_ok += cell["status"] == "ok"
                        n_skip += cell["status"] == "skipped"
                        continue
                print(f"[run]    {arch} {shape_name} {mesh_name} ...",
                      flush=True)
                cell = run_cell(arch, shape_name, mp, variant=args.variant,
                                depths=depths)
                with open(path, "w") as f:
                    json.dump(cell, f, indent=1)
                if cell["status"] == "ok":
                    n_ok += 1
                    mem = cell["memory"]["total_nonalias_bytes"] / 2 ** 30
                    print(f"         ok: trace {cell['trace_s']}s, mem/dev "
                          f"{mem:.2f} GiB, flops/dev "
                          f"{cell['cost']['flops_per_device']:.3e}, coll/dev "
                          f"{cell['collective_bytes_per_device'] / 2**20:.1f}"
                          f" MiB")
                elif cell["status"] == "skipped":
                    n_skip += 1
                    print(f"         skipped: {cell['reason'][:80]}")
                else:
                    n_err += 1
                    print(f"         ERROR: {cell['error']}")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
