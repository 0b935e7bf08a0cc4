"""The paper's own example network: a 5-layer CNN (50-80-120-200-350), the
port of ``repro.models.cnn``.

"In a modest-sized CNN — 5 convolutional layers, 50x80x120x200x350 neurons —
using internally 8-bit activations and 5x5 filters with 8-bit values, PCILTs
would need about 1.65 GB" (§Basic Version).  It runs with direct
multiplication (``mode="dm"``, the oracle) or any PCILT path of
:func:`repro_torch.core.lut_layers.pcilt_conv2d`.  Layouts are the
reference's: NHWC activations, HWIO filters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lut_layers import (conv_same_pads, flatten_filters,
                                         pad_nhwc, pcilt_conv2d)
from repro_torch.core.pcilt import build_grouped_tables
from repro_torch.core.quantization import QuantSpec, calibrate, fake_quant
from repro_torch.interop import resolve_device
from repro_torch.nn.module import ParamSpec, materialize

__all__ = ["PaperCNN", "PAPER_CHANNELS", "PAPER_FILTER", "MODES",
           "dm_conv2d"]

PAPER_CHANNELS = (50, 80, 120, 200, 350)
PAPER_FILTER = 5
#: ``forward`` modes: the direct-multiplication oracle and the PCILT paths
MODES = ("dm", "gather", "onehot", "kernel", "fused", "shared")


def dm_conv2d(x: torch.Tensor, w: torch.Tensor, spec: QuantSpec,
              scale) -> torch.Tensor:
    """Direct multiplication on the fake-quantized input: NHWC ``x``, HWIO
    ``w``, stride 1, XLA's SAME pads -> NHWC (``F.conv2d`` in NCHW
    inside)."""
    kh, kw = w.shape[:2]
    xq = fake_quant(x, spec, scale)
    xq = pad_nhwc(xq, conv_same_pads(x.shape[1], x.shape[2], kh, kw, 1))
    out = F.conv2d(xq.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).contiguous()


@dataclasses.dataclass
class PaperCNN:
    """5 conv layers + ReLU + global-average-pool classifier head, on
    ``device`` (parameters, tables and inputs live there)."""

    in_channels: int = 1
    n_classes: int = 10
    channels: tuple = PAPER_CHANNELS
    k: int = PAPER_FILTER
    act_spec: QuantSpec = QuantSpec(bits=8, symmetric=False)
    group: int = 1
    _: dataclasses.KW_ONLY
    device: str = "cuda"

    def param_specs(self):
        p = {}
        cin = self.in_channels
        for i, cout in enumerate(self.channels):
            p[f"conv{i}"] = ParamSpec((self.k, self.k, cin, cout),
                                      axes=(None, None, None, None))
            cin = cout
        p["head"] = ParamSpec((cin, self.n_classes), axes=(None, None))
        return p

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random parameters on the model's device."""
        return materialize(self.param_specs(), seed, device=self.device)

    def _check_device(self, x: torch.Tensor) -> None:
        dev = resolve_device(self.device)
        if x.device.type != dev.type:
            raise ValueError(f"input lies on {x.device}, the model runs on "
                             f"{dev}")

    def calibrate(self, params, x: torch.Tensor) -> Dict[str, float]:
        """Per-layer activation scales from a dense float forward (the
        quickstart's calibration pass), as host floats."""
        self._check_device(x)
        scales, h = {}, x
        for i in range(len(self.channels)):
            scales[f"conv{i}"] = float(calibrate(h, self.act_spec))
            w = params[f"conv{i}"]
            h = pad_nhwc(h, conv_same_pads(h.shape[1], h.shape[2],
                                           self.k, self.k, 1))
            h = F.relu(F.conv2d(h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
                       ).permute(0, 2, 3, 1).contiguous()
        return scales

    def forward(self, params, x: torch.Tensor, mode: str = "dm",
                scales: Optional[Dict] = None,
                tables: Optional[Dict] = None) -> torch.Tensor:
        """x ``[B, H, W, Cin]`` -> logits ``[B, n_classes]``.  ``mode``:
        ``"dm"`` (direct multiplication on fake-quantized inputs) or a PCILT
        path.  Activations are quantized to ``act_spec`` before every conv
        on both sides, so PCILT is exact against DM up to summation order.
        A layer without a scale calibrates on its own input; without
        ``tables`` each layer builds its own (``"shared"``: the extension-3
        pool)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self._check_device(x)
        scales = scales or {}
        for i in range(len(self.channels)):
            name = f"conv{i}"
            w = params[name]
            s = scales.get(name)
            if s is None:
                s = calibrate(x, self.act_spec)
            if mode == "dm":
                x = dm_conv2d(x, w, self.act_spec, s)
            else:
                x = pcilt_conv2d(
                    x, w, self.act_spec, s, group=self.group, path=mode,
                    tables=None if tables is None else tables[name])
            x = F.relu(x)
        x = x.float().mean(dim=(1, 2))  # [B, C]
        return torch.matmul(x, params["head"])

    def build_tables(self, params, scales: Dict) -> Dict:
        """Offline table build (once per network lifetime, paper §Basic):
        dense ``[G, V, Cout]`` tables per layer."""
        out = {}
        with torch.no_grad():
            for i in range(len(self.channels)):
                name = f"conv{i}"
                out[name] = build_grouped_tables(
                    flatten_filters(params[name], self.group), self.act_spec,
                    scales[name], self.group)
        return out
