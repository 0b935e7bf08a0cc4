"""PCILT construction and integrity (port of a subset of ``repro.core.pcilt``).

* grouped tables — one ``[V, out]`` table per segment of ``group`` weights,
  ``T[s, v, o] = sum_j w[s, j, o] * val(code_j(v))`` (paper extension 1);
* shared grouped tables — the grouped tables deduplicated to the ``X``
  unique segments, plus a ``seg_idx[G]`` pointer vector (extension 3);
* table checksums — CRC-32 over the raw bytes, identical to the reference's
  ``zlib.crc32(np.asarray(arr).tobytes())`` but streamed in fixed-size
  chunks, so a multi-GiB table never needs a whole host copy.  Per-layer
  checksums of a stack run in a thread pool (``zlib.crc32`` and the
  device-to-host copy both release the interpreter lock).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from .quantization import QuantSpec, code_values
from .offsets import offset_grid

__all__ = ["build_grouped_tables", "SharedGroupedTables",
           "build_shared_grouped_tables", "table_checksum",
           "stacked_checksums", "CRC_CHUNK_BYTES", "POOL_BUILD_ROWS"]

#: bytes handed to ``zlib.crc32`` per call (and copied to the host per step)
CRC_CHUNK_BYTES = 64 << 20
#: pool rows built per step of the shared-pool build (bounds its temporary)
POOL_BUILD_ROWS = 16


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
    return torch.einsum("vj,gjo->gvo", vals, w_seg)


@dataclasses.dataclass
class SharedGroupedTables:
    """Segment-deduplicated grouped tables: ``pool[X, V, out]`` holds the
    unique segment tables and ``seg_idx[G]`` points each segment at its
    pool row, so the dense tables are ``pool[seg_idx]``."""

    pool: torch.Tensor  # [X, V, out]
    seg_idx: torch.Tensor  # [G] int32
    group: int

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


def table_checksum(arr) -> int:
    """CRC-32 over the raw bytes of a table, streamed chunk by chunk."""
    b = _byte_view(arr)
    crc = 0
    for i in range(0, b.numel(), CRC_CHUNK_BYTES):
        crc = zlib.crc32(b[i:i + CRC_CHUNK_BYTES].cpu().numpy(), crc)
    return crc


def stacked_checksums(arr) -> List[int]:
    """Per-layer CRC-32s of a layer-major stack, one per slice along axis 0
    (each slice is a view, not a copy)."""
    workers = min(len(arr), os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        return list(pool.map(table_checksum, [arr[i] for i in range(len(arr))]))
