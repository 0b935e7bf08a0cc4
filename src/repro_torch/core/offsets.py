"""Activation codes -> PCILT offsets (port of ``repro.core.offsets``).

``group`` codes of ``bits`` bits each pack little-endian into one offset
(slot ``j`` occupies bits ``[j*bits, (j+1)*bits)``) — the paper's
shift-and-mask circuitry.  Only the contiguous segment layout is ported;
generalized ``SegmentPlan``s wait for a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["pack_offsets", "unpack_offsets", "offset_grid"]


def pack_offsets(codes: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """``[..., n]`` codes -> ``[..., n // group]`` int32 offsets."""
    if bits * group > 30:
        raise ValueError(f"offset width {bits * group} bits exceeds int32 packing")
    n = codes.shape[-1]
    if n % group:
        raise ValueError(f"reduction length {n} not divisible by group size {group}")
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], n // group, group)
    shifts = torch.arange(group, dtype=torch.int32, device=codes.device) * bits
    return torch.bitwise_left_shift(c, shifts).sum(-1, dtype=torch.int32)


def unpack_offsets(offsets: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Inverse of :func:`pack_offsets`: ``[..., G] -> [..., G*group]`` codes."""
    mask = (1 << bits) - 1
    shifts = torch.arange(group, dtype=torch.int32, device=offsets.device) * bits
    codes = torch.bitwise_and(
        torch.bitwise_right_shift(offsets.to(torch.int32)[..., None], shifts),
        mask)
    return codes.reshape(*offsets.shape[:-1], offsets.shape[-1] * group)


def offset_grid(bits: int, group: int, device=None) -> torch.Tensor:
    """All ``K**group`` offsets unpacked: ``[K**group, group]`` codes, row
    ``v`` holding the codes whose packed offset is ``v``."""
    n_off = 1 << (bits * group)
    v = torch.arange(n_off, dtype=torch.int32, device=device)[:, None]
    return unpack_offsets(v, bits, group)
