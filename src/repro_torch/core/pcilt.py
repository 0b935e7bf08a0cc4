"""PCILT construction and integrity (port of a subset of ``repro.core.pcilt``).

* grouped tables — one ``[V, out]`` table per segment of ``group`` weights,
  ``T[s, v, o] = sum_j w[s, j, o] * val(code_j(v))`` (paper extension 1);
* paired (TL1-style) tables — adjacent segment pairs merged into one
  ``[V**2, out]`` table, a grouped table at width ``2 * group``; a network's
  paired tables stack segment-major, ``[G2, L, V**2, out]``;
* shared grouped tables — the grouped tables deduplicated to the ``X``
  unique segments, plus a ``seg_idx[G]`` pointer vector (extension 3);
* memory and build-cost arithmetic of the paper (``table_bytes``,
  ``grouped_table_bytes``, ``shared_table_bytes``,
  ``build_cost_multiplies``);
* table checksums — CRC-32 over the raw bytes, identical to the reference's
  ``zlib.crc32(np.asarray(arr).tobytes())`` but streamed in fixed-size
  chunks, so a multi-GiB table never needs a whole host copy.  Per-layer
  checksums of a stack run in a thread pool (``zlib.crc32`` and the
  device-to-host copy both release the interpreter lock); a layer of a
  segment-major stack is a strided slice, streamed a few segments at a
  time.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from .quantization import QuantSpec, code_values
from .offsets import offset_grid

__all__ = ["table_bytes", "grouped_table_bytes", "shared_table_bytes",
           "build_cost_multiplies", "build_grouped_tables",
           "build_paired_tables", "build_paired_stacked_tables",
           "SharedGroupedTables",
           "build_shared_grouped_tables", "table_checksum", "layer_checksum",
           "stacked_checksums", "CRC_CHUNK_BYTES", "POOL_BUILD_ROWS"]

#: bytes handed to ``zlib.crc32`` per call (and copied to the host per step)
CRC_CHUNK_BYTES = 64 << 20
#: pool rows built per step of the shared-pool build (bounds its temporary)
POOL_BUILD_ROWS = 16


def table_bytes(n_weights: int, act_bits: int, value_bytes: int) -> int:
    """Basic-PCILT memory: one ``2**act_bits``-entry table per weight."""
    return n_weights * (1 << act_bits) * value_bytes


def grouped_table_bytes(n_weights: int, act_bits: int, group: int,
                        value_bytes: int) -> int:
    """Extension-1 memory: ``K**group`` entries per segment of ``group``
    weights."""
    segments = -(-n_weights // group)
    return segments * (1 << (act_bits * group)) * value_bytes


def shared_table_bytes(actual_cardinality: int, act_bits_list: Sequence[int],
                       value_bytes: int, nested: bool = False) -> int:
    """Extension-3 memory: unique tables only (``nested``: only the
    largest cardinality's table per base value is kept)."""
    if nested:
        return actual_cardinality * (1 << max(act_bits_list)) * value_bytes
    return actual_cardinality * sum(1 << b for b in act_bits_list) * value_bytes


def build_cost_multiplies(n_weights: int, act_bits: int) -> int:
    """Multiplications to build basic tables (paper: 5x5 INT8 -> 6,400)."""
    return n_weights * (1 << act_bits)


def _grid_values(spec: QuantSpec, scale, group: int, dtype, device):
    grid = offset_grid(spec.bits, group, device=device).long()  # [V, g]
    return code_values(spec, scale, dtype, device=device)[grid]  # [V, g]


def build_grouped_tables(w: torch.Tensor, spec: QuantSpec, scale, group: int,
                         dtype=torch.float32) -> torch.Tensor:
    """``w [n, out]`` -> ``T [G, V, out]`` over contiguous segments."""
    n, out = w.shape
    if n % group:
        raise ValueError(f"reduction length {n} not divisible by group size {group}")
    w_seg = w.reshape(n // group, group, out).to(dtype)
    vals = _grid_values(spec, scale, group, dtype, w.device)
    # contiguous: the kernels read tables in place (the einsum may return a
    # permuted view)
    return torch.einsum("vj,gjo->gvo", vals, w_seg).contiguous()


def build_paired_tables(w: torch.Tensor, spec: QuantSpec, scale, group: int,
                        dtype=torch.float32) -> torch.Tensor:
    """TL1-style paired tables ``[ceil(G/2), V**2, out]``: ``w [n, out]`` is
    zero-padded to a multiple of ``2 * group`` (group-alignment slots and,
    for an odd ``G``, a phantom segment, whose table rows are exactly 0)
    and built as grouped tables at width ``2 * group``.  The paired index is
    ``off_even + off_odd * V``, the fused kernels' little-endian pack of
    ``2 * group`` codes.  Contiguous."""
    n, out = w.shape
    pad = (-n) % (2 * group)
    if pad:
        w = torch.cat([w, w.new_zeros((pad, out))], 0)
    return build_grouped_tables(w, spec, scale, 2 * group, dtype)


def build_paired_stacked_tables(ws: torch.Tensor, spec: QuantSpec, scales,
                                group: int,
                                dtype=torch.float32) -> torch.Tensor:
    """Layer-stacked paired tables in segment-major layout
    ``[G2, L, V**2, out]`` from ``ws [L, n, out]`` and one scale per layer.
    Each layer is built in float32 into its slice of one preallocated stack
    of ``dtype`` (cast once), so the build holds one layer's tables beside
    the stack; the reference builds ``[L, G2, V**2, out]`` and transposes,
    which would hold the stack twice."""
    L, n, out = ws.shape
    G2 = -(-n // (2 * group))
    scales = torch.as_tensor(scales, dtype=torch.float32).cpu()
    stack = torch.empty((G2, L, 1 << (2 * spec.bits * group), out),
                        dtype=dtype, device=ws.device)
    for l in range(L):
        stack[:, l] = build_paired_tables(ws[l].float(), spec,
                                          float(scales[l]), group)
    return stack


@dataclasses.dataclass
class SharedGroupedTables:
    """Segment-deduplicated grouped tables: ``pool[X, V, out]`` holds the
    unique segment tables and ``seg_idx[G]`` points each segment at its
    pool row, so the dense tables are ``pool[seg_idx]``."""

    pool: torch.Tensor  # [X, V, out]
    seg_idx: torch.Tensor  # [G] int32
    group: int

    @property
    def n_segments(self) -> int:
        return int(self.seg_idx.shape[0])

    @property
    def pool_cardinality(self) -> int:
        return int(self.pool.shape[0])

    def pool_bytes(self) -> int:
        """Extension-3 memory: the unique segment tables plus the pointer
        vector (the reference's accounting)."""
        X, V, out = self.pool.shape
        return (shared_table_bytes(X, [(V - 1).bit_length()],
                                   out * self.pool.element_size())
                + self.n_segments * self.seg_idx.element_size())

    def lookup(self, offsets: torch.Tensor) -> torch.Tensor:
        """Gather path: offsets ``[..., G]`` -> ``[..., out]``."""
        partial = self.pool[self.seg_idx.long(), offsets.long()]
        return partial.sum(-2)


def build_shared_grouped_tables(w: torch.Tensor, spec: QuantSpec, scale,
                                group: int,
                                dtype=torch.float32) -> SharedGroupedTables:
    """Segment-level extension-3 build: segments whose ``[group, out]``
    weight blocks are identical share one pool row, and only the ``X``
    unique tables are built, ``POOL_BUILD_ROWS`` pool rows at a time into
    one preallocated pool (no whole-pool temporary)."""
    n, out = w.shape
    if n % group:
        raise ValueError(f"reduction length {n} not divisible by group size {group}")
    G = n // group
    uniq, inv = torch.unique(w.reshape(G, group * out), dim=0,
                             return_inverse=True)
    X = uniq.shape[0]
    uw = uniq.reshape(X, group, out).to(dtype)
    vals = _grid_values(spec, scale, group, dtype, w.device)
    pool = torch.empty((X, vals.shape[0], out), dtype=dtype, device=w.device)
    for i in range(0, X, POOL_BUILD_ROWS):
        pool[i:i + POOL_BUILD_ROWS] = torch.einsum(
            "vj,xjo->xvo", vals, uw[i:i + POOL_BUILD_ROWS])
    return SharedGroupedTables(pool=pool, seg_idx=inv.to(torch.int32),
                               group=group)


def _byte_view(arr) -> torch.Tensor:
    """A flat uint8 view of a tensor or array's bytes in C order."""
    if isinstance(arr, np.ndarray) or not torch.is_tensor(arr):
        a = np.ascontiguousarray(np.asarray(arr))
        return torch.from_numpy(a.reshape(-1).view(np.uint8))
    return arr.detach().contiguous().reshape(-1).view(torch.uint8)


def table_checksum(arr, crc: int = 0) -> int:
    """CRC-32 over the raw bytes of a table, streamed chunk by chunk
    (continuing ``crc``)."""
    b = _byte_view(arr)
    for i in range(0, b.numel(), CRC_CHUNK_BYTES):
        crc = zlib.crc32(b[i:i + CRC_CHUNK_BYTES].cpu().numpy(), crc)
    return crc


def layer_checksum(arr, layer: int, axis: int = 0) -> int:
    """CRC-32 of slice ``layer`` along ``axis`` of a stack, over its bytes
    in C order (the reference's ``table_checksum`` of the slice).  For
    ``axis=1`` (a segment-major ``[G2, L, V2, O]`` stack) the slice is
    strided: it is streamed a few contiguous ``[V2, O]`` segments at a
    time, at most ``CRC_CHUNK_BYTES`` of them, never copied whole."""
    if axis == 0:
        return table_checksum(arr[layer])
    if axis != 1:
        raise ValueError(f"stacks carry their layers on axis 0 or 1, got {axis}")
    seg = int(np.prod(arr.shape[2:])) * (arr.element_size()
                                         if torch.is_tensor(arr)
                                         else np.asarray(arr).itemsize)
    step = max(1, CRC_CHUNK_BYTES // max(seg, 1))
    crc = 0
    for g in range(0, arr.shape[0], step):
        crc = table_checksum(arr[g:g + step, layer], crc)
    return crc


def stacked_checksums(arr, axis: int = 0) -> List[int]:
    """Per-layer CRC-32s of a stack, one per slice along ``axis``: layer-major
    stacks (``[L, G, V, O]``) on axis 0, segment-major paired stacks
    (``[G2, L, V2, O]``) on axis 1 — the reference's record, byte for
    byte."""
    n = arr.shape[axis]
    workers = min(n, os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        return list(pool.map(lambda l: layer_checksum(arr, l, axis),
                             range(n)))
