"""Plain PyTorch reference of the paper's CNN under PCILT (arXiv:2104.01681,
"Basic Version"): 5x5 convolutions with stride 1 and XLA's SAME pads, each
input fake-quantized to the activation grid, ReLU after each, a global
average pool and a dense head.  NHWC activations, HWIO filters, float32.

A PCILT convolution fetches pre-summed products of a code and a filter
value, so it equals the convolution of the fake-quantized input up to the
order of the float32 sums.  The scales come from a dense float forward over
the calibration images, as the paper's offline step takes them.  This
module imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .quant import fake_quant, scale_from_amax


def same_pads(size: int, k: int) -> tuple:
    """XLA's SAME pads of one spatial axis at stride 1: ``k - 1`` in all,
    the smaller half first."""
    total = max(k - 1, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` by HWIO ``w``, stride 1, zero SAME pads -> NHWC."""
    kh, kw = w.shape[:2]
    hl, hh = same_pads(x.shape[1], kh)
    wl, wh = same_pads(x.shape[2], kw)
    xp = F.pad(x, (0, 0, wl, wh, hl, hh))
    out = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).contiguous()


def calibrate(params: Dict[str, torch.Tensor], cfg: Dict,
              x: torch.Tensor) -> List[float]:
    """Each layer's activation scale from a dense float forward over ``x``:
    the largest positive value on an asymmetric grid (``|x|`` on a
    symmetric one) over the grid's span."""
    scales, h = [], x
    for i in range(len(cfg["channels"])):
        a = h.abs() if cfg["act_symmetric"] else torch.clamp_min(h, 0.0)
        scales.append(float(scale_from_amax(a.amax(), cfg["act_bits"],
                                            cfg["act_symmetric"])))
        h = F.relu(conv_same(h, params[f"conv{i}"]))
    return scales


def forward(params: Dict[str, torch.Tensor], cfg: Dict, scales: List[float],
            x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> logits ``[B, n_classes]``."""
    for i in range(len(cfg["channels"])):
        xq = fake_quant(x, cfg["act_bits"], cfg["act_symmetric"], scales[i])
        x = F.relu(conv_same(xq, params[f"conv{i}"]))
    return torch.matmul(x.float().mean(dim=(1, 2)), params["head"])


def layout(cfg: Dict) -> List[tuple]:
    """``(path, shape, init, std)`` of every parameter: fan-in normal
    filters and head."""
    out, cin = [], cfg["in_channels"]
    k = cfg["filter"]
    for i, cout in enumerate(cfg["channels"]):
        out.append((f"conv{i}", (k, k, cin, cout), "normal",
                    (k * k * cin) ** -0.5))
        cin = cout
    out.append(("head", (cin, cfg["n_classes"]), "normal", cin ** -0.5))
    return out
