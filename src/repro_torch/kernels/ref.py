"""Pure-torch oracles of the fetch: readable statements of each kernel's
contract on host-packed offsets (port of ``repro.kernels.ref``)."""

from __future__ import annotations

import torch

__all__ = ["pcilt_gemv_ref", "pcilt_dwconv1d_ref"]


def pcilt_gemv_ref(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, G]``, tables ``[G, V, O]`` -> ``[B, O]``:
    ``sum_g T[g, off[b, g], :]`` in float32, cast once to the table dtype."""
    seg = torch.arange(tables.shape[0], device=tables.device)
    picked = tables[seg, offsets.long()]  # [B, G, O]
    return picked.float().sum(1).to(tables.dtype)


def pcilt_dwconv1d_ref(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, T, C]``, tables ``[C, V]`` -> ``[B, T, C]``:
    ``T[c, off[b, t, c]]``."""
    ch = torch.arange(tables.shape[0], device=tables.device)
    return tables[ch, offsets.long()]
