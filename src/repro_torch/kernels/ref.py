"""Pure-torch oracles of the fetch: readable statements of each kernel's
contract on host-packed offsets (port of ``repro.kernels.ref``).

:func:`fetch_sum` is the one gather-and-sum of the port: every plain
version of a GEMV or conv kernel in ``kernels.ops`` reduces to it."""

from __future__ import annotations

import torch

__all__ = ["PLAIN_CHUNK_ELEMS", "fetch_sum", "fetch_sum_sliced",
           "dense_rows", "pool_rows",
           "pcilt_gemv_ref", "pcilt_conv2d_ref", "pcilt_dwconv1d_ref"]

#: elements of the ``[rows, G, O]`` gather that :func:`fetch_sum` holds at
#: once (it runs in chunks of rows: one conv4 pixel of the paper CNN
#: gathers 1.75 M cells)
PLAIN_CHUNK_ELEMS = 1 << 26


def fetch_sum(rows: torch.Tensor, tab2d: torch.Tensor) -> torch.Tensor:
    """``rows [M, G]`` row indices into ``tab2d [R, O]`` (``-1``: the
    segment adds nothing) -> ``[M, O]``: the rows summed in float32 and cast
    once to the table dtype, ``PLAIN_CHUNK_ELEMS`` gathered cells at a
    time."""
    M, G = rows.shape
    O = tab2d.shape[1]
    out = torch.empty((M, O), dtype=tab2d.dtype, device=tab2d.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(G * O, 1))
    zero = torch.zeros((), device=tab2d.device)
    for m in range(0, M, step):
        r = rows[m:m + step].long()
        picked = tab2d[r.clamp_min(0)].float()  # [m, G, O]
        picked = torch.where((r >= 0)[..., None], picked, zero)
        out[m:m + step] = picked.sum(1).to(tab2d.dtype)
    return out


def fetch_sum_sliced(rows: torch.Tensor, tab2d: torch.Tensor,
                     slices) -> torch.Tensor:
    """:func:`fetch_sum` in the order of a kernel that splits the segment
    loop: each ``(g0, g1)`` slice of ``slices`` adds its rows one at a time
    in ascending ``g`` in float32, then the slice sums are added in slice
    order and cast once (the order of ``kernels.ops.shared_gemv_variant``'s
    split; a ``-1`` row adds nothing)."""
    M, _ = rows.shape
    total = None
    for g0, g1 in slices:
        acc = torch.zeros((M, tab2d.shape[1]), device=tab2d.device)
        for g in range(g0, g1):
            r = rows[:, g].long()
            acc = acc + torch.where((r >= 0)[:, None],
                                    tab2d[r.clamp_min(0)].float(), 0.0)
        total = acc if total is None else total + acc
    return total.to(tab2d.dtype)


def dense_rows(offsets: torch.Tensor, V: int, stride: int = 0,
               base: int = 0) -> torch.Tensor:
    """Offsets ``[M, G]`` -> rows ``base + g*stride + off`` (``stride``
    defaults to ``V``: the ``[G*V, O]`` view of dense tables; a
    segment-major paired stack ``[G2, L, V2, O]`` has ``stride = L*V2`` and
    ``base = layer*V2``); an offset outside ``[0, V)`` adds nothing (the
    one-hot fetch of the reference matches no row for it)."""
    off = offsets.long()
    seg = torch.arange(off.shape[-1], device=off.device) * (stride or V) + base
    return torch.where((off >= 0) & (off < V), seg + off, -1)


def pool_rows(offsets: torch.Tensor, seg_idx: torch.Tensor, X: int,
              V: int) -> torch.Tensor:
    """Offsets ``[M, G]`` -> rows ``seg_idx[g]*V + off`` of the ``[X*V, O]``
    view of a shared pool; a pointer outside ``[0, X)`` adds nothing."""
    idx = seg_idx.long()
    base = torch.where((idx >= 0) & (idx < X), idx * V, -1)
    return torch.where(base >= 0, base + offsets.long(), -1)


def pcilt_gemv_ref(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, G]``, tables ``[G, V, O]`` -> ``[B, O]``:
    ``sum_g T[g, off[b, g], :]`` in float32, cast once to the table dtype."""
    G, V, O = tables.shape
    return fetch_sum(dense_rows(offsets, V), tables.reshape(G * V, O))


def pcilt_conv2d_ref(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, H, W, G]``, tables ``[G, V, O]`` -> ``[B, H, W, O]``."""
    B, H, W, G = offsets.shape
    flat = pcilt_gemv_ref(offsets.reshape(-1, G), tables)
    return flat.reshape(B, H, W, tables.shape[-1])


def pcilt_dwconv1d_ref(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, T, C]``, tables ``[C, V]`` -> ``[B, T, C]``:
    ``T[c, off[b, t, c]]``, 0 where an offset lies outside ``[0, V)`` (the
    reference's masked sum over the ``V`` entries matches none)."""
    C, V = tables.shape
    off = offsets.long()
    ok = (off >= 0) & (off < V)
    ch = torch.arange(C, device=tables.device)
    got = tables[ch, torch.where(ok, off, 0)]
    return torch.where(ok, got, torch.zeros((), dtype=tables.dtype,
                                            device=tables.device))
