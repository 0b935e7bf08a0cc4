"""The work a request needs, counted from the published shapes: the
operations and bytes of the least time a kernel could take, and the dense
network's model FLOPs.

* The paper CNN (one image): one float32 fetch-add per multiply-add of the
  dense convolution; each table, input and output byte counted once.
* The full-PCILT Mamba2 decode (one step of ``batch`` rows): of every
  projection the table rows the batch's codes name (``batch`` rows a
  segment), of the conv frontend one table entry a channel and row, the
  conv and SSD states read and written, and of the shared-pool head the
  named pool rows.  One add a fetched float32 value.

Model FLOPs are 2 a multiply-add of the dense network at its published
widths.
"""

from __future__ import annotations

from typing import Dict

F32 = 4


def cnn_image(cfg: Dict, height: int, width: int) -> Dict:
    """``{"ops", "bytes", "model_flops", "layers": [...]}`` of one image."""
    k, group, bits = cfg["filter"], cfg["group"], cfg["act_bits"]
    V = 1 << (bits * group)
    hw = height * width
    layers, cin = [], cfg["in_channels"]
    for cout in cfg["channels"]:
        macs = hw * k * k * cin * cout
        G = -(-k * k * cin // group)
        layers.append({"macs": macs, "ops": macs,
                       "table_cells": G * V * cout,
                       "bytes": (G * V * cout + hw * cin + hw * cout) * F32})
        cin = cout
    head = cin * cfg["n_classes"]
    return {"ops": sum(l["ops"] for l in layers),
            "bytes": sum(l["bytes"] for l in layers),
            "model_flops": 2 * (sum(l["macs"] for l in layers) + head),
            "layers": layers}


def _mamba_dims(cfg: Dict):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    H = di // cfg["head_dim"]
    gn = cfg["n_groups"] * cfg["d_state"]
    return d, di, H, gn, di + 2 * gn


def mamba_step(cfg: Dict, batch: int) -> Dict:
    """``{"ops", "bytes"}`` of one decode step of ``batch`` rows."""
    d, di, H, gn, C = _mamba_dims(cfg)
    g, N, P, k = cfg["group"], cfg["d_state"], cfg["head_dim"], \
        cfg["conv_kernel"]
    vp = cfg["vocab"] + (-cfg["vocab"]) % cfg["pad_vocab_to"]
    seg_in, seg_out = -(-d // g), -(-di // g)
    proj = sum(seg_in * batch * o for o in (di, di, gn, gn, H)) \
        + seg_out * batch * d
    conv = batch * C
    states = 2 * batch * ((k - 1) * C + H * N * P)
    layer_values = proj + conv
    head = seg_in * batch * vp
    values = cfg["n_layers"] * layer_values + head
    return {"ops": values,
            "bytes": (values + cfg["n_layers"] * states) * F32}


def mamba_token_flops(cfg: Dict) -> int:
    """Model FLOPs of one token through the dense network: the six
    projections, the depthwise conv, the state update and readout, and
    the head over the published vocabulary."""
    d, di, H, gn, C = _mamba_dims(cfg)
    N, P, k = cfg["d_state"], cfg["head_dim"], cfg["conv_kernel"]
    layer = d * (2 * di + 2 * gn + H) + di * d + k * C + 2 * H * N * P
    return 2 * (cfg["n_layers"] * layer + d * cfg["vocab"])
