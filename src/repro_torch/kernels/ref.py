"""Pure-torch oracles of the fetch: readable statements of each kernel's
contract on host-packed offsets (port of ``repro.kernels.ref``), and the
plain version of the CRC-32 kernel with its host-side GF(2) arithmetic.

:func:`fetch_sum` is the one gather-and-sum of the port: every plain
version of a GEMV or conv kernel in ``kernels.ops`` reduces to it.
:func:`crc32_plain` computes ``zlib.crc32`` the way
``csrc/pcilt_crc32.cu`` does: lane slices, chunks, a tree of combines."""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["PLAIN_CHUNK_ELEMS", "fetch_sum", "fetch_sum_sliced",
           "dense_rows", "pool_rows",
           "pcilt_gemv_ref", "pcilt_conv2d_ref", "pcilt_dwconv1d_ref",
           "CRC_LANE_BYTES", "CRC_CHUNK_BYTES", "CRC_LEVELS", "crc_multmodp",
           "crc_shift", "crc_tables", "crc_operators", "crc32_finish",
           "crc32_plain"]

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


# ----------------------------------------------------------------------------
# CRC-32 (zlib's polynomial, bit-reflected) by chunks and combines
#
# A CRC without zlib's pre- and post-inversion (the "pure" CRC, started from
# 0) is linear over GF(2) and blind to leading zero bytes:
#   pure(A || B) = pure(A) * x^(8|B|) mod P  xor  pure(B).
# So the bytes are cut into lane slices of CRC_LANE_BYTES, 32 of which make
# a chunk (one warp's work in the kernel); the stream is padded with zero
# bytes at its FRONT to whole chunks, and with zero chunks in front to a
# power of two, so every node of the combine tree at level j covers
# CRC_LANE_BYTES * 2**j bytes and one operator serves the whole level.
# zlib's inversions are applied once, at the ends (crc32_finish).
# ----------------------------------------------------------------------------

#: bytes one lane CRCs (a lane slice) and bytes of one chunk (a warp's 32
#: slices); the kernel's constants are checked against these
CRC_LANE_BYTES = 2048
CRC_CHUNK_BYTES = 32 * CRC_LANE_BYTES
#: levels of the combine tree the operator table covers: level j shifts by
#: CRC_LANE_BYTES * 2**j bytes (levels 0-4 inside a chunk, 5 on across
#: chunks)
CRC_LEVELS = 48
_POLY = 0xEDB88320
_MASK = 0xFFFFFFFF


def crc_multmodp(a: int, b: int) -> int:
    """``a * b mod P`` in the bit-reflected representation (zlib's
    ``multmodp``: bit 31 is ``x^0``)."""
    p, m = 0, 1 << 31
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1
        m >>= 1
    return p


@functools.lru_cache(maxsize=None)
def _x2n(k: int) -> int:
    """``x^(2^k) mod P``."""
    return 1 << 30 if k == 0 else crc_multmodp(_x2n(k - 1), _x2n(k - 1))


def _x8nmodp(n: int) -> int:
    """``x^(8n) mod P``: the shift by ``n`` zero bytes (zlib's
    ``x2nmodp(n, 3)``)."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = crc_multmodp(_x2n(k), p)
        n >>= 1
        k += 1
    return p


def crc_shift(crc: int, nbytes: int) -> int:
    """The pure CRC ``crc`` moved past ``nbytes`` zero bytes."""
    return crc_multmodp(_x8nmodp(nbytes), crc & _MASK)


@functools.lru_cache(maxsize=None)
def crc_tables() -> np.ndarray:
    """The slicing-by-16 tables ``[16, 256]`` uint32 (the kept design's;
    the first 4 are the banked design's slicing-by-4): ``T[k][b]`` is the
    pure CRC of byte ``b`` followed by ``k`` zero bytes."""
    t = np.zeros((16, 256), np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[0, b] = c
    for k in range(1, 16):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


@functools.lru_cache(maxsize=None)
def crc_operators() -> np.ndarray:
    """``[CRC_LEVELS, 32]`` uint32: row ``j`` holds the columns of the
    shift by ``CRC_LANE_BYTES * 2**j`` bytes, so that the shift of ``v`` is
    the xor of the columns ``i`` where bit ``i`` of ``v`` is set."""
    ops = np.zeros((CRC_LEVELS, 32), np.uint32)
    for j in range(CRC_LEVELS):
        a = _x8nmodp(CRC_LANE_BYTES << j)
        for i in range(32):
            ops[j, i] = crc_multmodp(a, 1 << i)
    return ops


def crc32_finish(pure: int, nbytes: int, crc: int = 0) -> int:
    """``zlib.crc32(data, crc)`` from the pure CRC of ``nbytes`` bytes of
    ``data``: zlib starts from ``~crc`` and inverts at the end."""
    return (pure ^ crc_shift(~crc & _MASK, nbytes) ^ _MASK) & _MASK


def _byte_views(pieces: Sequence[torch.Tensor]):
    out = []
    for p in pieces:
        if not p.is_contiguous():
            raise ValueError(f"CRC pieces must be contiguous (got strides "
                             f"{p.stride()} for shape {tuple(p.shape)})")
        if p.numel():
            out.append(p.detach().reshape(-1).view(torch.uint8))
    return out


def _apply_op(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The shift ``op`` (32 columns, int64) of each pure CRC in ``v``."""
    r = torch.zeros_like(v)
    for i in range(32):
        r ^= ((v >> i) & 1) * op[i]
    return r


def crc32_plain(pieces: Sequence[torch.Tensor], crc: int = 0) -> int:
    """``zlib.crc32`` (continuing ``crc``) of the concatenated C-order
    bytes of contiguous tensors, on their device, by the kernel's
    arithmetic: the stream padded in front to whole chunks, each lane
    slice's pure CRC by slicing-by-4 over its 4-byte words (the "banked"
    design's step; the kept design's slicing-by-16 gives the same CRCs),
    the 32 slices of a chunk combined pairwise (levels 0-4), the chunks
    padded in front with zero chunks to a power of two and combined
    pairwise (levels 5 on), zlib's inversions applied once at the ends."""
    bufs = _byte_views(pieces)
    total = sum(b.numel() for b in bufs)
    if total == 0:
        return crc
    dev = bufs[0].device
    nchunks = -(-total // CRC_CHUNK_BYTES)
    pad = nchunks * CRC_CHUNK_BYTES - total
    stream = torch.cat([torch.zeros(pad, dtype=torch.uint8, device=dev),
                        *bufs])
    words = stream.view(torch.int32).reshape(
        nchunks * 32, CRC_LANE_BYTES // 4).long() & _MASK
    tab = torch.from_numpy(crc_tables()[:4].astype(np.int64)).to(dev)
    c = torch.zeros(words.shape[0], dtype=torch.int64, device=dev)
    for i in range(words.shape[1]):  # one little-endian word a step
        x = words[:, i] ^ c  # byte s of the word reads T[3 - s]
        c = (tab[3][x & 0xFF] ^ tab[2][(x >> 8) & 0xFF]
             ^ tab[1][(x >> 16) & 0xFF] ^ tab[0][x >> 24])
    ops = torch.from_numpy(crc_operators().astype(np.int64)).to(dev)
    level = 0
    node = c.reshape(nchunks, 32)
    n = 1 << (nchunks - 1).bit_length()
    node = torch.cat([torch.zeros((n - nchunks, 32), dtype=torch.int64,
                                  device=dev), node]).reshape(-1)
    while node.numel() > 1:
        node = _apply_op(ops[level], node[0::2]) ^ node[1::2]
        level += 1
    return crc32_finish(int(node[0]), total, crc)
