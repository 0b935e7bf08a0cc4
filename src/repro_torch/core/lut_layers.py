"""PCILT inference layers (port of a subset of ``repro.core.lut_layers``).

Paths of :func:`pcilt_linear`:

* ``"gather"`` — the literal algorithm: quantize, pack offsets, gather the
  table rows and sum them (the reference semantics);
* ``"fused"`` with ``stacked=layer`` — the layer-stacked fused GEMV kernel
  over ``[L, G, V, O]`` tables (``kernels.ops.pcilt_fused_gemv_stacked``);
  the layer is selected by pointer arithmetic, never copied;
* ``"shared"`` — the shared-pool fused GEMV over a
  :class:`~repro_torch.core.pcilt.SharedGroupedTables`
  (``kernels.ops.pcilt_shared_gemv``).

The depthwise conv1d maps the ``k`` taps of a channel onto one segment, so
one fetch of ``T[c, pack(codes)]`` is one output (``path="fused"`` runs
``kernels.ops.pcilt_fused_dwconv1d``).  ``return_stats`` returns the
saturation ``(count, ratio)`` of the quantizer feeding the fetch; the kernel
routes reduce them in the kernel, the others on the side.
"""

from __future__ import annotations

from typing import Optional

import torch

from .quantization import QuantSpec, code_values, quantize, quantize_with_stats
from .offsets import offset_grid, pack_offsets
from .pcilt import SharedGroupedTables

__all__ = ["lut_lookup", "pcilt_linear", "build_dwconv_tables",
           "pcilt_depthwise_conv1d"]


def lut_lookup(tables: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Fetch-and-sum ``sum_s T[s, off[..., s], :]``: tables ``[G, V, O]``,
    offsets ``[..., G]`` -> ``[..., O]``."""
    G = tables.shape[0]
    seg = torch.arange(G, device=tables.device)
    return tables[seg, offsets.long()].sum(-2)


def pcilt_linear(x: torch.Tensor, tables, spec: QuantSpec, scale, group: int,
                 path: str = "gather", stacked: Optional[int] = None,
                 return_stats: bool = False):
    """Quantize -> pack offsets -> fetch -> sum: ``x [..., n] -> [..., out]``.

    ``tables`` is a dense ``[G, V, out]`` tensor, a layer-stacked
    ``[L, G, V, out]`` one with ``stacked=`` (the layer index, a host int),
    or a :class:`SharedGroupedTables` pool.  With ``return_stats`` the call
    returns ``(out, count, ratio)``."""
    if stacked is not None:
        if isinstance(tables, SharedGroupedTables) or tables.dim() != 4:
            raise ValueError(
                f"stacked= executes layer-stacked dense [L, G, V, O] tables, "
                f"got {type(tables).__name__} "
                f"{getattr(tables, 'shape', '')}")
        L, G, V, O = tables.shape
        if path == "fused":
            from repro_torch.kernels import ops

            flat = x.reshape(-1, x.shape[-1])
            res = ops.pcilt_fused_gemv_stacked(flat, tables, stacked, spec,
                                               scale, group,
                                               with_stats=return_stats)
            if return_stats:
                out, count, ratio = res
                return out.reshape(*x.shape[:-1], O), count, ratio
            return res.reshape(*x.shape[:-1], O)
        tables = tables[stacked]  # a view of the layer: the reference path
    if path == "shared":
        if not isinstance(tables, SharedGroupedTables):
            raise ValueError(
                "path='shared' executes a SharedGroupedTables pool; build one "
                "with build_shared_grouped_tables (got dense tables)")
        from repro_torch.kernels import ops

        flat = x.reshape(-1, x.shape[-1])
        out = ops.pcilt_shared_gemv(flat, tables.pool, tables.seg_idx, spec,
                                    scale, tables.group)
        out = out.reshape(*x.shape[:-1], tables.pool.shape[-1])
        if return_stats:
            _, count, ratio = quantize_with_stats(x, spec, scale)
            return out, count, ratio
        return out
    if path != "gather":
        raise ValueError(
            f"path {path!r} is not ported: the port runs 'gather', 'shared' "
            f"and 'fused' with stacked=")
    if return_stats:
        codes, count, ratio = quantize_with_stats(x, spec, scale)
    else:
        codes = quantize(x, spec, scale)
    offsets = pack_offsets(codes, spec.bits, group)
    if isinstance(tables, SharedGroupedTables):
        out = tables.lookup(offsets)
    else:
        out = lut_lookup(tables, offsets)
    if return_stats:
        return out, count, ratio
    return out


def _dwconv_pads(k: int, padding: str):
    try:
        return {"CAUSAL": (k - 1, 0),
                "SAME": ((k - 1) // 2, k - 1 - (k - 1) // 2),
                "VALID": (0, 0)}[padding]
    except KeyError:
        raise ValueError(
            f"padding must be CAUSAL|SAME|VALID, got {padding!r}") from None


def build_dwconv_tables(filters: torch.Tensor, spec: QuantSpec,
                        scale) -> torch.Tensor:
    """Per-channel depthwise-conv1d PCILTs: ``[k, C]`` filters -> ``[C, V]``
    (slot ``j`` of an offset is tap ``j``)."""
    k, _ = filters.shape
    grid = offset_grid(spec.bits, k, device=filters.device).long()
    vals = code_values(spec, scale, device=filters.device)[grid]  # [V, k]
    return torch.einsum("vk,kc->cv", vals, filters.to(vals.dtype))


def pcilt_depthwise_conv1d(x: torch.Tensor, filters: torch.Tensor,
                           spec: QuantSpec, scale,
                           tables: Optional[torch.Tensor] = None,
                           path: str = "gather", padding: str = "CAUSAL",
                           return_stats: bool = False):
    """Depthwise conv1d where one fetch produces one output element.

    ``x [B, T, C]``, ``filters [k, C]``; ``padding`` CAUSAL | SAME | VALID.
    ``path="fused"`` runs the fused kernel wrapper; ``"gather"`` builds the
    offset tensor explicitly."""
    k, C = filters.shape
    if tables is None:
        tables = build_dwconv_tables(filters, spec, scale)
    if path == "fused":
        from repro_torch.kernels import ops

        return ops.pcilt_fused_dwconv1d(x, tables, spec, scale, k,
                                        padding=padding,
                                        with_stats=return_stats)
    if path != "gather":
        raise ValueError(f"unknown path {path!r}")
    if return_stats:
        codes, count, ratio = quantize_with_stats(x, spec, scale)
    else:
        codes = quantize(x, spec, scale)
    lo, hi = _dwconv_pads(k, padding)
    padded = torch.nn.functional.pad(codes.to(torch.int32), (0, 0, lo, hi))
    To = padded.shape[1] - k + 1
    off = sum(padded[:, j:j + To] << (j * spec.bits) for j in range(k))
    out = tables[torch.arange(C, device=tables.device), off.long()]
    if return_stats:
        return out, count, ratio
    return out
