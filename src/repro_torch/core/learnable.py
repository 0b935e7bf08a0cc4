"""Extension 4 — "Using PCILTs as Weights" (port of ``repro.core.learnable``).

The table entries become the learnable parameters.  The effective table is
``T_eff = (base + offset_delta) * table_scale * filter_scale +
entry_delta``, and each of the paper's four granularities trains one
factor beside ``base``:

* ``filter`` — one scalar per output filter;
* ``table`` — one scalar per (segment, output) table;
* ``offset`` — one delta per offset, shared by every table;
* ``entry`` — every table cell.

Gradients flow through the plain gather or one-hot fetch (the gather's
backward scatter-adds into the cells that were addressed).  No gradient
reaches the activations: the reference quantizes them behind a stop
gradient, and so does this port.  The host-packed kernel has no
backward, as the reference's has none: ``path="kernel"`` refuses tables
that require grad and serves them under ``torch.no_grad()``.
``extract_filters`` rebuilds classic filters from a table by least squares.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .quantization import QuantSpec, code_values, quantize
from .offsets import offset_grid, pack_offsets
from .pcilt import build_grouped_tables
from .lut_layers import lut_lookup

__all__ = ["GRANULARITIES", "init_learnable_pcilt", "apply_learnable_pcilt",
           "effective_tables", "extract_filters"]

GRANULARITIES = ("filter", "table", "offset", "entry")


def init_learnable_pcilt(generator: Optional[torch.Generator], n_in: int,
                         n_out: int, spec: QuantSpec, scale: float,
                         group: int, granularity: str = "entry",
                         base_weights: Optional[torch.Tensor] = None,
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Parameters of one learnable layer, every leaf requiring grad.
    ``base`` is built from ``base_weights`` when given (warm start), else
    from normal weights drawn with ``generator`` (on its device) and scaled
    by ``1/sqrt(n_in)``."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}")
    G = -(-n_in // group)
    V = 1 << (spec.bits * group)
    if base_weights is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or base_weights")
        base_weights = torch.randn((G * group, n_out), generator=generator,
                                   dtype=dtype, device=generator.device) \
            * (1.0 / n_in ** 0.5)
    dev = base_weights.device
    pad = G * group - base_weights.shape[0]
    if pad:
        base_weights = torch.cat(
            [base_weights, base_weights.new_zeros((pad, n_out))], 0)
    params = {"base": build_grouped_tables(base_weights.detach(), spec, scale,
                                           group, dtype=dtype)}
    if granularity == "filter":
        params["filter_scale"] = torch.ones((n_out,), dtype=dtype, device=dev)
    elif granularity == "table":
        params["table_scale"] = torch.ones((G, n_out), dtype=dtype,
                                           device=dev)
    elif granularity == "offset":
        params["offset_delta"] = torch.zeros((V,), dtype=dtype, device=dev)
    else:
        params["entry_delta"] = torch.zeros((G, V, n_out), dtype=dtype,
                                            device=dev)
    return {k: v.requires_grad_() for k, v in params.items()}


def effective_tables(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Combine ``base`` and the adjustment into the table the fetch uses."""
    t = params["base"]
    if "offset_delta" in params:
        t = t + params["offset_delta"][None, :, None]
    if "table_scale" in params:
        t = t * params["table_scale"][:, None, :]
    if "filter_scale" in params:
        t = t * params["filter_scale"][None, None, :]
    if "entry_delta" in params:
        t = t + params["entry_delta"]
    return t


def apply_learnable_pcilt(params: Dict[str, torch.Tensor], x: torch.Tensor,
                          spec: QuantSpec, scale: float, group: int,
                          path: str = "gather") -> torch.Tensor:
    """Forward ``[..., n_in] -> [..., n_out]``, differentiable in the
    parameters on ``"gather"`` and ``"onehot"``."""
    tables = effective_tables(params)
    if path == "kernel" and tables.requires_grad:
        raise ValueError(
            "path='kernel' (the host-packed GEMV kernel) has no backward, as "
            "the reference's has none: train through path='gather' or "
            "'onehot', and serve the trained tables through 'kernel' under "
            "torch.no_grad()")
    G = tables.shape[0]
    pad = G * group - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], -1)
    codes = quantize(x.detach(), spec, scale)
    return lut_lookup(tables, pack_offsets(codes, spec.bits, group), path)


def extract_filters(tables: torch.Tensor, spec: QuantSpec, scale: float,
                    group: int) -> torch.Tensor:
    """Least-squares filters ``[G * group, out]`` behind ``tables [G, V,
    out]``: per segment, ``pinv(vals) @ T_seg`` with ``vals [V, group]`` the
    unpacked offset values; exact for tables built as products."""
    G, V, O = tables.shape
    dev = tables.device
    grid = offset_grid(spec.bits, group, device=dev).long()
    vals = code_values(spec, scale, device=dev)[grid]  # [V, g]
    w_seg = torch.einsum("gv,svo->sgo", torch.linalg.pinv(vals),
                         tables.to(vals.dtype))
    return w_seg.reshape(G * group, O)
