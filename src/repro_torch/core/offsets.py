"""Activation codes -> PCILT offsets (port of ``repro.core.offsets``).

``group`` codes of ``bits`` bits each pack little-endian into one offset
(slot ``j`` occupies bits ``[j*bits, (j+1)*bits)``) — the paper's
shift-and-mask circuitry.

A generalized layout (paper Fig. 7) is a :class:`SegmentPlan`: an index
map that may group non-adjacent positions, skip positions or use one
position in several segments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["pack_offsets", "unpack_offsets", "offset_grid", "SegmentPlan"]


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


def offset_grid(bits: int, group: int, *, device=None) -> torch.Tensor:
    """All ``K**group`` offsets unpacked: ``[K**group, group]`` codes, row
    ``v`` holding the codes whose packed offset is ``v``."""
    n_off = 1 << (bits * group)
    v = torch.arange(n_off, dtype=torch.int32, device=device)[:, None]
    return unpack_offsets(v, bits, group)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Generalized activation -> segment mapping (paper Fig. 7).

    ``index [G, group]`` (a host int32 array) gives, for each segment slot,
    the input position that feeds it; ``-1`` marks an unused slot, which
    reads as code 0 against a zero weight.  A position may feed several
    segments or none.  The index is validated once, here (``>= -1``), and
    against the input width ``n`` by every method that meets one.
    """

    index: np.ndarray  # int32 [G, group]
    _on_device: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False, kw_only=True)

    def __post_init__(self):
        idx = np.asarray(self.index)
        if idx.ndim != 2 or not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(f"a SegmentPlan index is an integer [G, group] "
                             f"array, got {idx.dtype} {idx.shape}")
        if idx.size and idx.min() < -1:
            raise ValueError(f"SegmentPlan index entries must be >= -1 "
                             f"(-1 = unused slot), got {idx.min()}")
        object.__setattr__(self, "index", idx.astype(np.int32))

    @staticmethod
    def contiguous(n: int, group: int) -> "SegmentPlan":
        if n % group:
            raise ValueError(f"reduction length {n} not divisible by group "
                             f"size {group}")
        return SegmentPlan(np.arange(n, dtype=np.int32).reshape(-1, group))

    @property
    def n_segments(self) -> int:
        return self.index.shape[0]

    @property
    def group(self) -> int:
        return self.index.shape[1]

    def check(self, n: int) -> None:
        """Raise unless every position of the plan lies in ``[0, n)``."""
        if self.index.size and self.index.max() >= n:
            raise ValueError(f"SegmentPlan reads position {self.index.max()} "
                             f"of an input of width {n}")

    def on(self, device) -> torch.Tensor:
        """The index as an int32 tensor on ``device`` (uploaded once)."""
        key = str(torch.device(device))
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = torch.from_numpy(self.index).to(device)
        return t

    def _take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Gather ``t`` along ``dim`` by the plan, 0 in the unused slots:
        the ``[G, group]`` plan axes replace ``dim``."""
        self.check(t.shape[dim])
        idx = self.on(t.device)
        g = torch.index_select(t, dim, idx.clamp_min(0).reshape(-1).long())
        g = g.reshape(*t.shape[:dim], *self.index.shape, *t.shape[dim + 1:])
        mask = (idx >= 0).reshape(*self.index.shape,
                                  *([1] * (t.dim() - dim - 1)))
        return torch.where(mask, g, torch.zeros((), dtype=t.dtype,
                                                device=t.device))

    def gather_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``[..., n] -> [..., G, group]`` codes per segment slot (skips ->
        0)."""
        return self._take(codes, codes.dim() - 1)

    def gather_weights(self, w: torch.Tensor) -> torch.Tensor:
        """``[n, ...] -> [G, group, ...]`` weight per segment slot (skips ->
        0)."""
        return self._take(w, 0)

    def pack(self, codes: torch.Tensor, bits: int) -> torch.Tensor:
        """Codes ``[..., n] -> offsets [..., G]`` following the plan."""
        seg = self.gather_codes(codes).to(torch.int32)
        shifts = torch.arange(self.group, dtype=torch.int32,
                              device=codes.device) * bits
        return torch.bitwise_left_shift(seg, shifts).sum(-1, dtype=torch.int32)
