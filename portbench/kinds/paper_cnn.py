"""How the paper-CNN configurations run: ``PaperCNN.forward(params, x,
mode=cfg["path"], scales=, tables=)`` over a closed loop of images.

Set-up: the filters and head from the seed on the card, the calibration
images from the seed, the port's ``calibrate`` and ``build_tables`` (timed
as ``convert_s``), one warm forward at the traffic's image shape.  The
window sends one image at a time and waits for its logits.  Afterwards
the tables are freed and the reference recomputes the scales and the
logits of every image served; the number compared is the largest
difference of a logit over that image's largest reference logit.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from .. import trace as tr
from .. import traffic as traffic_gen
from .. import weights, work
from ..manifest import module
from ..reference.quant import tf32

#: the window's images traced in a ``--trace 1`` run (each later one only
#: when the earlier ones lost records)
PROFILED_IMAGES = (1, 3, 5)


def _model(cfg: Dict, device):
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.models.cnn import PaperCNN

    return PaperCNN(in_channels=cfg["in_channels"],
                    n_classes=cfg["n_classes"],
                    channels=tuple(cfg["channels"]), k=cfg["filter"],
                    act_spec=QuantSpec(bits=cfg["act_bits"],
                                       symmetric=cfg["act_symmetric"]),
                    group=cfg["group"], device=device)


def _check_layout(model, params) -> None:
    want = weights.shapes(model.param_specs())
    got = weights.shapes(params)
    if want != got:
        raise RuntimeError(f"the port's parameters {want} are not the "
                           f"reference's {got}")


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Marked:
    """The port's convolution entry, with a marker kernel launched before
    and after each call (``trace`` segments ``conv<i>`` and ``after<i>``)."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn

    def __call__(self, *a, **kw):
        tr.marker(self.torch)
        out = self.fn(*a, **kw)
        tr.marker(self.torch)
        return out


def _traced_forward(torch, forward, n_layers: int):
    """One forward under the profiler; the stretch and its labels."""
    import repro_torch.models.cnn as cnn_mod
    from repro_torch.kernels import ops

    labels = []
    for i in range(n_layers):
        labels += [f"conv{i}", f"after{i}"]
    plain = cnn_mod.pcilt_conv2d
    cnn_mod.pcilt_conv2d = _Marked(torch, plain)
    before = sum(ops.LAUNCHES.values())
    try:
        with tr.Stretch(torch) as s:
            out = forward()
    finally:
        cnn_mod.pcilt_conv2d = plain
    s.ops_launches = sum(ops.LAUNCHES.values()) - before
    return out, s, labels


def run(ctx: Dict) -> Dict:
    import torch

    cfg, traffic, seed = ctx["cfg"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    ref = module("reference", cfg["reference"])
    traffic_gen.check(traffic)
    if cfg["table_dtype"] != "float32":
        raise ValueError("the paper CNN's tables are float32")
    model = _model(cfg, device)
    params = weights.make(ref.layout(cfg), seed, device)
    _check_layout(model, params)
    shape = tuple(traffic["shape"])
    calib_shape = (cfg["calibration_images"],) + shape[1:]
    calib = next(traffic_gen.images(dict(traffic, shape=calib_shape), seed,
                                     device, stream="calibration"))

    t0 = time.perf_counter()
    with torch.no_grad():
        scales = model.calibrate(params, calib)
        tables = model.build_tables(params, scales)
    _sync(torch, device)
    convert_s = time.perf_counter() - t0

    def forward(x):
        with torch.no_grad():
            return model.forward(params, x, mode=cfg["path"], scales=scales,
                                 tables=tables).cpu()

    forward(next(traffic_gen.images(traffic, seed, device, stream="warmup")))
    traced = ctx["trace"] and device != "cpu"
    if traced:
        tr.warm(torch)
    stream = traffic_gen.images(traffic, seed, device)
    images, logits = [], []
    stretches = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx["seconds"] or not images:
        x = next(stream)
        if traced and len(images) in PROFILED_IMAGES and not any(
                _whole(st) for st in stretches):
            y, s, labels = _traced_forward(torch, lambda: forward(x),
                                           len(cfg["channels"]))
            stretches.append((s, labels))
        else:
            y = forward(x)
        images.append(x)
        logits.append(y)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del tables
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    rec = {"setup_s": t_start - ctx["t_process"],
           "window": {"seconds": window_s, "requests": len(images),
                      "images": len(images) * shape[0]},
           "attempted": len(images), "failed": 0,
           "spans": {"convert_s": convert_s},
           "work": {"image": work.cnn_image(cfg, shape[1], shape[2])},
           "memory_peak_bytes": peak, "diag": [],
           "trace": next((t for t in (_read_trace(st, shape[0])
                                      for st in stretches) if t), None)}
    if rec["trace"]:
        t = rec["trace"]
        rec["diag"].append(f"traced one forward: {t['port_launches']} "
                           f"launches of the port's kernels, ops.LAUNCHES "
                           f"counted {t['ops_launches']} calls")
    rec["checks"], rec["numbers"], rec["control"], diag = judge(
        torch, ref, cfg, params, calib, images, logits, ctx["limits"],
        ctx.get("control"))
    rec["diag"] += diag
    return rec


def _whole(stretch) -> bool:
    """Every marker and every counted launch of the port's kernels is in
    the stretch's trace."""
    s, labels = stretch
    return tr.segments(s.events, labels) is not None and \
        tr.launches(s.events, port_only=True) >= s.ops_launches


def _read_trace(stretch, batch: int) -> Dict:
    if not _whole(stretch):
        return None
    s, labels = stretch
    segs = tr.segments(s.events, labels)
    what = {lab: (f"conv{lab[4:]}: host between its kernels"
                  if lab.startswith("conv")
                  else f"after conv{lab[5:]}: ReLU, the next layer's set-up, "
                       "or the pool, head and logits read back")
            for lab in labels}
    body = [e for lab in labels for e in segs[lab]]
    return {"window_s": s.window_s, "busy_s": tr.busy_s(body),
            "units": batch,
            "device_s": tr.device_s(body),
            "segments": {lab: {"device_s": tr.device_s(segs[lab]),
                               "launches": tr.launches(segs[lab])}
                         for lab in labels},
            "port_launches": tr.launches(body, port_only=True),
            "ops_launches": s.ops_launches,
            "device_ops": tr.top_ops(body),
            "idle_gaps": tr.idle_gaps(s.events, labels, what)}


def judge(torch, ref, cfg, params, calib, images: List, logits: List,
          limits: Dict, control=None):
    """``({"logit_err": [value, limit]}, the port's numbers, the control's
    numbers, diagnostics)``:
    the reference's scales from the same calibration images, its logits of
    every image served; with ``control`` also the control's reading."""
    lim = limits["numbers"]["logit_err"]["limit"]
    scales = ref.calibrate(params, cfg, calib)
    worst, worst_ctl = 0.0, 0.0
    for x, y in zip(images, logits):
        with torch.no_grad():
            want = ref.forward(params, cfg, scales, x).cpu()
        den = want.abs().amax(-1).clamp_min(1e-30)
        err = ((y.float() - want).abs().amax(-1) / den).max()
        worst = max(worst, float(err) if torch.isfinite(err) else
                    float("inf"))
        if control == "tf32":
            with tf32(torch):
                got = ref.forward(params, cfg, scales, x).cpu()
            worst_ctl = max(worst_ctl, float(
                ((got - want).abs().amax(-1) / den).max()))
    ctl = {"logit_err": worst_ctl} if control else {}
    return ({"logit_err": [worst, lim]}, {"logit_err": worst}, ctl,
            [f"control {control}: {ctl}"] if control else [])
