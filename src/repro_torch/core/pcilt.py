"""PCILT construction and integrity (port of ``repro.core.pcilt`` without its
mesh-sharded pools).

* scalar tables — one ``[K, out]`` table per weight, ``T[k, a, o] =
  fn(w[k, o], val(a))`` (the basic algorithm);
* grouped tables — one ``[V, out]`` table per segment of ``group`` weights,
  ``T[s, v, o] = sum_j fn(w[s, j, o], val(code_j(v)))`` (paper extension
  1); segments are contiguous or follow a generalized ``SegmentPlan``;
* convolutional functions — ``fn`` need not be multiplication (extension
  2): :func:`mul_fn` is the classic product, :func:`log_mul_fn` a
  log-compressed one; only the build evaluates ``fn``;
* shared tables — the scalar tables deduplicated to the weights' unique
  values, ``w_idx`` pointing each weight at its pool row (extension 3,
  optionally a second level onto unique table values);
* paired (TL1-style) tables — adjacent segment pairs merged into one
  ``[V**2, out]`` table, a grouped table at width ``2 * group``; a network's
  paired tables stack segment-major, ``[G2, L, V**2, out]``;
* shared grouped tables — the grouped tables deduplicated to the ``X``
  unique segments, plus a ``seg_idx[G]`` pointer vector (extension 3);
* memory and build-cost arithmetic of the paper (``table_bytes``,
  ``grouped_table_bytes``, ``shared_table_bytes``,
  ``build_cost_multiplies``);
* table checksums — CRC-32 over the raw bytes, identical to the reference's
  ``zlib.crc32(np.asarray(arr).tobytes())``.  A CUDA tensor's bytes go
  through the CRC kernel on the card (``kernels.ops.pcilt_crc32``) and
  never to the host (:func:`checksums` takes several tables or layers in
  one launch); a CPU tensor's through ``zlib.crc32``, streamed in
  fixed-size chunks, several in a thread pool (``zlib.crc32`` releases
  the interpreter lock).  A layer of a segment-major stack is a strided
  slice: its contiguous segments are the kernel's ranges, or are streamed
  one after another to ``zlib``.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .quantization import QuantSpec, code_values
from .offsets import SegmentPlan, offset_grid

__all__ = ["mul_fn", "log_mul_fn", "table_bytes", "grouped_table_bytes",
           "shared_table_bytes", "shared_pool_bytes", "build_cost_multiplies",
           "build_scalar_tables", "build_grouped_tables",
           "build_paired_tables", "build_paired_stacked_tables",
           "SharedTables", "build_shared_tables", "SharedGroupedTables",
           "build_shared_grouped_tables", "table_checksum", "layer_checksum",
           "stacked_checksums", "checksums", "CRC_CHUNK_BYTES", "POOL_BUILD_ROWS",
           "FN_BUILD_ELEMS"]

#: bytes handed to ``zlib.crc32`` per call
CRC_CHUNK_BYTES = 64 << 20
#: pool rows built per step of the shared-pool build (bounds its temporary)
POOL_BUILD_ROWS = 16
#: elements of the ``[S, C, group, out]`` temporary a build with a custom
#: ``fn`` holds at once (one float32 temporary over all of qwen3-0.6b's
#: gate tables would take 3.2 GB)
FN_BUILD_ELEMS = 1 << 26


def mul_fn(w, a):
    """The classic convolution: plain product."""
    return w * a


def log_mul_fn(w, a, gamma: float = 1.0):
    """A log-compressed product, ``sign(p) * log1p(gamma * |p|) / gamma``
    (the paper's re-scaling of the inferred value range)."""
    p = w * a
    return torch.sign(p) * torch.log1p(gamma * torch.abs(p)) / gamma


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


def shared_pool_bytes(pool_cardinality: int, act_bits: int, group: int,
                      out: int, value_bytes: int, n_segments: int = 0,
                      ptr_bytes: int = 4) -> int:
    """Segment-level extension-3 memory: ``X`` unique ``[K**group, out]``
    segment tables, plus the ``[G]`` pointer vector when ``n_segments`` is
    given."""
    return (shared_table_bytes(pool_cardinality, [act_bits * group],
                               out * value_bytes)
            + n_segments * ptr_bytes)


def build_cost_multiplies(n_weights: int, act_bits: int) -> int:
    """Multiplications to build basic tables (paper: 5x5 INT8 -> 6,400)."""
    return n_weights * (1 << act_bits)


def _grid_values(spec: QuantSpec, scale, group: int, dtype, device):
    grid = offset_grid(spec.bits, group, device=device).long()  # [V, g]
    return code_values(spec, scale, dtype, device=device)[grid]  # [V, g]


def _segments(w: torch.Tensor, group: int,
              plan: Optional[SegmentPlan]) -> torch.Tensor:
    """``w [n, out]`` -> ``[G, group, out]`` weights per segment slot:
    contiguous segments (a view) or ``plan.gather_weights(w)``."""
    if plan is not None:
        return plan.gather_weights(w)
    n, out = w.shape
    if n % group:
        raise ValueError(f"reduction length {n} not divisible by group size "
                         f"{group}")
    return w.reshape(n // group, group, out)


def _fn_tables(w_seg: torch.Tensor, vals: torch.Tensor, fn: Callable,
               build_chunk: int) -> torch.Tensor:
    """``T[s, v, o] = sum_j fn(w_seg[s, j, o], vals[v, j])`` for a custom
    ``fn``, into one preallocated contiguous ``[S, V, out]`` tensor: at most
    ``build_chunk`` offsets and ``FN_BUILD_ELEMS`` temporary elements a
    step."""
    S, g, out = w_seg.shape
    V = vals.shape[0]
    res = torch.empty((S, V, out), dtype=w_seg.dtype, device=w_seg.device)
    s_step = max(1, min(S, FN_BUILD_ELEMS // max(g * out, 1)))
    v_step = max(1, min(build_chunk, FN_BUILD_ELEMS // (s_step * g * out)))
    for s0 in range(0, S, s_step):
        ws = w_seg[s0:s0 + s_step, None]  # [s, 1, g, out]
        for v0 in range(0, V, v_step):
            vc = vals[v0:v0 + v_step, :, None]  # [c, g, 1]
            res[s0:s0 + s_step, v0:v0 + v_step] = fn(ws, vc).sum(2)
    return res


def build_scalar_tables(w: torch.Tensor, spec: QuantSpec, scale,
                        fn: Callable = mul_fn,
                        dtype=torch.float32) -> torch.Tensor:
    """Basic PCILT: ``w [n, out]`` -> ``T [n, K, out]`` with ``T[k, a, o] =
    fn(w[k, o], val(a))``."""
    vals = code_values(spec, scale, dtype, device=w.device)  # [K]
    return fn(w[:, None, :].to(dtype), vals[None, :, None]).contiguous()


def build_grouped_tables(w: torch.Tensor, spec: QuantSpec, scale, group: int,
                         plan: Optional[SegmentPlan] = None,
                         fn: Callable = mul_fn, dtype=torch.float32,
                         build_chunk: int = 4096) -> torch.Tensor:
    """``w [n, out]`` -> ``T [G, V, out]``, ``V = K**group``, segments
    contiguous or following ``plan``.  Contiguous; a custom ``fn`` builds
    in bounded steps (:func:`_fn_tables`)."""
    w_seg = _segments(w, group, plan).to(dtype)
    group = w_seg.shape[1]
    vals = _grid_values(spec, scale, group, dtype, w.device)
    if fn is not mul_fn:
        return _fn_tables(w_seg, vals, fn, build_chunk)
    # contiguous: the kernels read tables in place (the einsum may return a
    # permuted view)
    return torch.einsum("vj,gjo->gvo", vals, w_seg).contiguous()


def build_paired_tables(w: torch.Tensor, spec: QuantSpec, scale, group: int,
                        fn: Callable = mul_fn, dtype=torch.float32,
                        build_chunk: int = 4096) -> torch.Tensor:
    """TL1-style paired tables ``[ceil(G/2), V**2, out]``: ``w [n, out]`` is
    zero-padded to a multiple of ``2 * group`` (group-alignment slots and,
    for an odd ``G``, a phantom segment, whose table rows are exactly 0
    under :func:`mul_fn`) and built as grouped tables at width ``2 *
    group``.  The paired index is ``off_even + off_odd * V``, the fused
    kernels' little-endian pack of ``2 * group`` codes.  Contiguous."""
    n, out = w.shape
    pad = (-n) % (2 * group)
    if pad:
        w = torch.cat([w, w.new_zeros((pad, out))], 0)
    return build_grouped_tables(w, spec, scale, 2 * group, fn=fn, dtype=dtype,
                                build_chunk=build_chunk)


def build_paired_stacked_tables(ws: torch.Tensor, spec: QuantSpec, scales,
                                group: int, fn: Callable = mul_fn,
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
                                          float(scales[l]), group, fn=fn)
    return stack


@dataclasses.dataclass
class SharedTables:
    """Weight-deduplicated scalar PCILT pool (extension 3): ``pool[x, a] =
    fn(unique_w[x], val(a))`` and ``w_idx [n, out]`` points every weight at
    its pool row.  With ``value_pool`` set, ``pool`` holds int32 indices
    into the unique table values ``value_pool [U]`` (the second level)."""

    pool: torch.Tensor  # [X, K] table values, or int32 indices
    w_idx: torch.Tensor  # [n, out] int32 pointers into pool rows
    unique_w: torch.Tensor  # [X]
    value_pool: Optional[torch.Tensor] = None  # [U]
    _grouped: Optional["SharedGroupedTables"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _values(self) -> torch.Tensor:
        if self.value_pool is None:
            return self.pool
        return self.value_pool[self.pool.long()]

    def as_grouped_pool(self) -> "SharedGroupedTables":
        """The scalar pool as a 1-wide segment pool (``group=1``): each of
        the ``n`` weight positions is a segment whose ``[K, out]`` table its
        pointer row selects; positions with identical pointer rows share one
        pool row (``np.unique`` over the rows, the reference's order).  The
        dense ``[n, K, out]`` tables are never built.  Cached."""
        if self._grouped is None:
            rows, inv = np.unique(self.w_idx.cpu().numpy(), axis=0,
                                  return_inverse=True)  # [X', out]
            rows_t = torch.from_numpy(rows).to(self.pool.device).long()
            seg_pool = self._values()[rows_t].transpose(1, 2).contiguous()
            self._grouped = SharedGroupedTables(
                pool=seg_pool,  # [X', K, out]
                seg_idx=torch.from_numpy(inv.reshape(-1).astype(np.int32))
                .to(self.pool.device), group=1)
        return self._grouped

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[..., n]`` -> ``[..., out]`` through the 1-wide segment
        pool's pointer gather."""
        return self.as_grouped_pool().lookup(codes.to(torch.int32))

    def materialize(self) -> torch.Tensor:
        """The dense per-weight tables ``[n, K, out]`` (for parity tests and
        memory comparisons; no execution path calls it)."""
        return self._values()[self.w_idx.long()].transpose(1, 2).contiguous()

    @property
    def actual_cardinality(self) -> int:
        return int(self.unique_w.shape[0])


def build_shared_tables(w: torch.Tensor, spec: QuantSpec, scale,
                        fn: Callable = mul_fn, dedup_values: bool = False,
                        dtype=torch.float32) -> SharedTables:
    """The shared pool of weights whose actual cardinality is small: one
    ``[K]`` table per unique weight value (``np.unique`` on the host, the
    reference's order); ``dedup_values`` adds the second level onto unique
    table values."""
    w_np = w.detach().cpu().numpy()
    uniq, inv = np.unique(w_np, return_inverse=True)
    dev = w.device
    vals = code_values(spec, scale, dtype, device=dev)  # [K]
    unique_w = torch.from_numpy(uniq).to(device=dev, dtype=dtype)
    pool = fn(unique_w[:, None], vals[None, :])  # [X, K]
    value_pool = None
    if dedup_values:
        pv, pinv = np.unique(pool.cpu().numpy(), return_inverse=True)
        value_pool = torch.from_numpy(pv).to(device=dev, dtype=dtype)
        pool = torch.from_numpy(pinv.reshape(pool.shape).astype(np.int32)) \
            .to(dev)
    return SharedTables(
        pool=pool,
        w_idx=torch.from_numpy(inv.reshape(w_np.shape).astype(np.int32))
        .to(dev),
        unique_w=unique_w, value_pool=value_pool)


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

    def pool_bytes(self, value_bytes: Optional[int] = None) -> int:
        """Extension-3 memory: the unique segment tables plus the pointer
        vector (the reference's accounting)."""
        X, V, out = self.pool.shape
        vb = value_bytes or self.pool.element_size()
        return (shared_table_bytes(X, [(V - 1).bit_length()], out * vb)
                + self.n_segments * self.seg_idx.element_size())

    def dense_bytes(self, value_bytes: Optional[int] = None) -> int:
        """What the equivalent dense ``[G, V, out]`` tables would take."""
        _, V, out = self.pool.shape
        return self.n_segments * V * out * (value_bytes
                                            or self.pool.element_size())

    @property
    def dedup_ratio(self) -> float:
        """Dense-to-pool table-memory ratio (about ``G / X``)."""
        return self.dense_bytes() / max(self.pool_bytes(), 1)

    def materialize(self) -> torch.Tensor:
        """The dense grouped tables ``[G, V, out]`` (parity tests; the
        shared-pool kernel never calls it)."""
        return self.pool[self.seg_idx.long()]

    def lookup(self, offsets: torch.Tensor) -> torch.Tensor:
        """Gather path: offsets ``[..., G]`` -> ``[..., out]``."""
        partial = self.pool[self.seg_idx.long(), offsets.long()]
        return partial.sum(-2)


def build_shared_grouped_tables(w: torch.Tensor, spec: QuantSpec, scale,
                                group: int,
                                plan: Optional[SegmentPlan] = None,
                                fn: Callable = mul_fn, dtype=torch.float32,
                                build_chunk: int = 4096) -> SharedGroupedTables:
    """Segment-level extension-3 build: segments (contiguous or following
    ``plan``) whose ``[group, out]`` weight blocks are identical share one
    pool row, and only the ``X`` unique tables are built, ``POOL_BUILD_ROWS``
    pool rows at a time into one preallocated pool (no whole-pool
    temporary)."""
    w_seg = _segments(w, group, plan)
    G, group, out = w_seg.shape
    uniq, inv = torch.unique(w_seg.reshape(G, group * out), dim=0,
                             return_inverse=True)
    X = uniq.shape[0]
    uw = uniq.reshape(X, group, out).to(dtype)
    vals = _grid_values(spec, scale, group, dtype, w.device)
    pool = torch.empty((X, vals.shape[0], out), dtype=dtype, device=w.device)
    for i in range(0, X, POOL_BUILD_ROWS):
        rows = uw[i:i + POOL_BUILD_ROWS]
        pool[i:i + POOL_BUILD_ROWS] = (
            torch.einsum("vj,xjo->xvo", vals, rows) if fn is mul_fn
            else _fn_tables(rows, vals, fn, build_chunk))
    return SharedGroupedTables(pool=pool, seg_idx=inv.to(torch.int32),
                               group=group)


def _byte_view(arr) -> torch.Tensor:
    """A flat uint8 view of a tensor or array's bytes in C order."""
    if isinstance(arr, np.ndarray) or not torch.is_tensor(arr):
        a = np.ascontiguousarray(np.asarray(arr))
        return torch.from_numpy(a.reshape(-1).view(np.uint8))
    return arr.detach().contiguous().reshape(-1).view(torch.uint8)


def _on_cuda(arr) -> bool:
    return torch.is_tensor(arr) and arr.device.type == "cuda"


def _itemsize(arr) -> int:
    return arr.element_size() if torch.is_tensor(arr) \
        else np.asarray(arr).itemsize


def _layer_ranges(arr, layer: int, axis: int):
    """Byte starts and length of slice ``layer`` along ``axis`` of a stack's
    C-order bytes: one range for a layer-major ``[L, ...]`` stack (axis 0);
    ``G2`` ranges of one ``[V2, O]`` segment, ``L`` segments apart, for a
    segment-major ``[G2, L, V2, O]`` stack (axis 1)."""
    if axis == 0:
        n = int(np.prod(arr.shape[1:])) * _itemsize(arr)
        return np.array([layer * n], np.int64), n
    if axis != 1:
        raise ValueError(f"stacks carry their layers on axis 0 or 1, got {axis}")
    seg = int(np.prod(arr.shape[2:])) * _itemsize(arr)
    return (layer * seg + arr.shape[1] * seg
            * np.arange(arr.shape[0], dtype=np.int64)), seg


def _zlib_ranges(arr, starts, length: int) -> int:
    """``zlib.crc32`` of a host table's byte ranges, back to back, handed to
    zlib at most ``CRC_CHUNK_BYTES`` at a time."""
    b = _byte_view(arr)
    crc = 0
    for a in starts:
        for i in range(a, a + length, CRC_CHUNK_BYTES):
            crc = zlib.crc32(b[i:min(i + CRC_CHUNK_BYTES, a + length)].numpy(),
                             crc)
    return crc


def checksums(items) -> List[int]:
    """CRC-32 of each item, over its bytes in C order: an item is a table,
    or ``(stack, layer, axis)`` for slice ``layer`` along ``axis`` of a
    stack (the reference's ``table_checksum`` of the slice; a strided
    segment-major slice is never copied).  CUDA tables go through the CRC
    kernel on the card, all the items in one launch with one read back;
    host tables through ``zlib``, several items in a thread pool.  A CUDA
    tensor's bytes never go to the host."""
    specs, flat = [], {}
    for it in items:
        arr, layer, axis = it if isinstance(it, tuple) else (it, None, 0)
        if id(arr) not in flat:  # each table made contiguous once
            flat[id(arr)] = (arr.detach().contiguous() if torch.is_tensor(arr)
                             else np.ascontiguousarray(np.asarray(arr)))
        arr = flat[id(arr)]
        if layer is None:
            starts, n = np.zeros(1, np.int64), _itemsize(arr) * int(
                np.prod(arr.shape))
        else:
            starts, n = _layer_ranges(arr, layer, axis)
        specs.append((arr, starts, n))
    on_card = [_on_cuda(a) for a, _, _ in specs]
    if any(on_card):
        if not all(on_card):
            raise ValueError("checksums: the items lie on the card and on "
                             "the host; checksum each device's apart")
        from repro_torch.kernels import ops

        return ops.pcilt_crc32(specs)
    if len(specs) <= 1:
        return [_zlib_ranges(*sp) for sp in specs]
    workers = min(len(specs), os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda sp: _zlib_ranges(*sp), specs))


def table_checksum(arr, *, crc: int = 0) -> int:
    """CRC-32 over the raw bytes of a table (continuing ``crc``): on the
    card for a CUDA tensor, else ``zlib.crc32`` streamed chunk by chunk."""
    got = checksums([arr])[0]
    if crc == 0:
        return got
    from repro_torch.kernels.ref import crc_shift

    n = _itemsize(arr) * int(np.prod(np.shape(arr)))
    return crc_shift(crc, n) ^ got  # zlib's crc32_combine


def layer_checksum(arr, layer: int, axis: int = 0) -> int:
    """CRC-32 of slice ``layer`` along ``axis`` of a stack (layer-major
    ``[L, G, V, O]`` on axis 0, segment-major ``[G2, L, V2, O]`` on axis
    1), over its bytes in C order: :func:`checksums` of one item."""
    return checksums([(arr, layer, axis)])[0]


def stacked_checksums(arr, axis: int = 0) -> List[int]:
    """Per-layer CRC-32s of a stack, one per slice along ``axis`` — the
    reference's record, byte for byte.  A CUDA stack's layers take one
    kernel launch; a host stack's go through a thread pool."""
    return checksums([(arr, l, axis) for l in range(arr.shape[axis])])
