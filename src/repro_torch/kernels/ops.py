"""Wrappers of the PCILT CUDA kernels, their launch counts and their plain
PyTorch versions (port of the main-path part of ``repro.kernels.ops``).

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors launches its kernel on ``torch.cuda.current_stream()``
  (raising if the launch returns a CUDA error) and adds one to its count in
  :data:`LAUNCHES`;
* on CPU tensors, and only there, runs its plain version — the
  gather-and-sum of the same formula (the counterpart of Pallas
  ``interpret=True``).  There is no fallback from one to the other.

The fused kernels take the activations in float32 and the scale as a host
scalar, cast to the activations' dtype (float32) as the reference's
``_scale_2d`` does; the host-packed ones take int32 offsets.  Tables are
used in place: no wrapper pads or transposes a table.  The conv wrappers'
only host-side work is the spatial zero pad of the float image.

The conv kernels come in two designs (``csrc/pcilt_conv2d.cu``):
``"staged"`` (a code pre-pass, then table slices staged in shared memory;
``V <= 256``) and ``"direct"`` (every cell fetched from the table; any
``V``).  :func:`conv_variant` chooses by shape; :data:`CONV_VARIANT_LAUNCHES`
counts which one ran.  ``_fused_conv2d`` / ``_shared_conv2d`` take
``variant=`` to force either on a CUDA tensor (tests and ``chip_smoke.py``);
neither falls back to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.offsets import pack_offsets
from repro_torch.core.quantization import QuantSpec, quantize, quantize_with_stats
from repro_torch.core.lut_layers import (_conv_pads, _dwconv_pads,
                                         conv_offsets, pad_nhwc)
from . import build
from .ref import (dense_rows, fetch_sum, pcilt_dwconv1d_ref,
                  pcilt_gemv_ref, pool_rows)

__all__ = ["LAUNCHES", "reset_launches", "pcilt_fused_gemv",
           "pcilt_fused_gemv_stacked", "pcilt_fused_gemv_paired",
           "pcilt_fused_gemv_paired_stacked", "pcilt_fused_gemv_plan",
           "pcilt_fused_dwconv1d",
           "pcilt_dwconv1d", "pcilt_shared_gemv", "pcilt_gemv",
           "pcilt_conv2d", "pcilt_fused_conv2d", "pcilt_shared_conv2d",
           "fused_gemv_plain", "gemv_stacked_plain", "gemv_paired_plain",
           "gemv_paired_stacked_plain", "gemv_plan_plain", "dwconv1d_plain",
           "shared_gemv_plain", "fused_conv2d_plain", "shared_conv2d_plain",
           "CONV_VARIANT_LAUNCHES", "conv_variant", "staged_smem_bytes",
           "staged_tiles", "staged_block_tile", "conv_codes_plain"]

#: kernel name -> number of launches of its CUDA kernel in this process
LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}

_TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


#: conv design -> number of fused/shared conv2d calls it served on CUDA
CONV_VARIANT_LAUNCHES: Dict[str, int] = {"staged": 0, "direct": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, CONV_VARIANT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one
    CUDA device; raises for anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check_launch(name: str, x: torch.Tensor, table: torch.Tensor,
                  *others: torch.Tensor) -> str:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: activations must be float32, got {x.dtype}")
    return _check_tables(name, table, x, *others)


def _check_tables(name: str, table: torch.Tensor,
                  *others: torch.Tensor) -> str:
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"{name}: tables must be float32 or bfloat16, got "
                        f"{table.dtype}")
    for t in (table, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous "
                             f"(got strides {t.stride()} for shape "
                             f"{tuple(t.shape)})")
    return _TABLE_DTYPES[table.dtype]


def _host_scale(scale) -> float:
    """The per-tensor scale as a float32 host scalar."""
    s = np.asarray(scale.detach().cpu() if torch.is_tensor(scale) else scale,
                   np.float32)
    if s.size != 1:
        raise ValueError(f"fused kernels take a per-tensor (scalar) scale, "
                         f"got shape {s.shape}")
    return float(s.reshape(()))


def _call(name: str, fn, x: torch.Tensor, *args) -> None:
    """Launch ``fn`` on ``x``'s current stream; raise on a CUDA error."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    _call(name, fn, x, *args)
    LAUNCHES[name] += 1


def _stats_out(stats: torch.Tensor):
    return stats[0], stats[1:].view(torch.float32)[0]


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# ----------------------------------------------------------------------------
# Fused GEMVs: unstacked, layer-stacked, paired, paired stacked and
# plan-gathered (one kernel: a segment stride, a layer offset, a pack width
# and, for a generalized SegmentPlan, a gather index)
# ----------------------------------------------------------------------------


def _gemv_plain(x, tab2d, rows_of, spec: QuantSpec, scale, pw: int,
                with_stats: bool):
    """Quantize, pack ``pw`` codes per offset, gather the rows
    ``rows_of(offsets)`` of ``tab2d`` and sum them in float32."""
    s = torch.as_tensor(_host_scale(scale), dtype=x.dtype, device=x.device)
    codes, count, ratio = quantize_with_stats(x, spec, s)
    out = fetch_sum(rows_of(pack_offsets(codes, spec.bits, pw)), tab2d)
    return (out, count, ratio) if with_stats else out


def fused_gemv_plain(x, tables, spec: QuantSpec, scale, group: int):
    """Plain version of the unstacked fused GEMV over ``[G, V, O]``."""
    G, V, O = tables.shape
    return _gemv_plain(x, tables.reshape(G * V, O),
                       lambda off: dense_rows(off, V), spec, scale, group,
                       False)


def gemv_stacked_plain(x, tables, layer, spec: QuantSpec, scale, group: int,
                       with_stats: bool = False):
    """Plain version of the stacked kernel: quantize, pack, gather the rows
    of ``tables[layer]`` and sum them in float32."""
    _, G, V, O = tables.shape
    return _gemv_plain(x, tables[layer].reshape(G * V, O),
                       lambda off: dense_rows(off, V), spec, scale, group,
                       with_stats)


def gemv_paired_plain(x, tables, spec: QuantSpec, scale, group: int,
                      with_stats: bool = False):
    """Plain version of the paired GEMV over ``[G2, V2, O]``: the dense
    fetch at width ``2 * group``."""
    G2, V2, O = tables.shape
    return _gemv_plain(x, tables.reshape(G2 * V2, O),
                       lambda off: dense_rows(off, V2), spec, scale,
                       2 * group, with_stats)


def gemv_paired_stacked_plain(x, tables, layer, spec: QuantSpec, scale,
                              group: int, with_stats: bool = False):
    """Plain version of the paired stacked GEMV over the segment-major
    ``[G2, L, V2, O]`` stack: rows ``(g * L + layer) * V2 + off`` of its
    ``[G2 * L * V2, O]`` view (the layer is never copied out)."""
    G2, L, V2, O = tables.shape
    return _gemv_plain(x, tables.reshape(G2 * L * V2, O),
                       lambda off: dense_rows(off, V2, L * V2, layer * V2),
                       spec, scale, 2 * group, with_stats)


def _check_gemv(x, G, V, spec: QuantSpec, pw: int, what=None):
    """Shapes of a fused GEMV; ``what`` names ``G * pw`` when ``x`` must
    have that width (the plan GEMV takes any)."""
    B, n = x.shape
    if what is not None and n != G * pw:
        raise ValueError(f"x trailing dim {n} != {what} = {G}*{pw} "
                         f"(x {tuple(x.shape)})")
    if spec.bits * pw > 30:
        raise ValueError(f"offset width {spec.bits * pw} bits exceeds int32 "
                         f"packing")
    if V != 1 << (spec.bits * pw):
        raise ValueError(f"tables value axis {V} != 2**(bits*{pw}) = "
                         f"{1 << (spec.bits * pw)}")
    if B < 1:
        raise ValueError("empty batch")


def _launch_gemv(name, x, tables, G, O, pw, seg_stride, layer_off,
                 spec: QuantSpec, scale, with_stats):
    """One launch of the fused GEMV kernel: segment ``g`` of the call is the
    ``[V, O]`` table at element ``layer_off + g * seg_stride``."""
    dt = _check_launch(name, x, tables)
    B = x.shape[0]
    if B * G * 4 > 227 * 1024:
        raise ValueError(f"B*G = {B * G} offsets exceed the shared memory "
                         f"of one block")
    out = torch.empty((B, O), dtype=tables.dtype, device=x.device)
    stats = torch.zeros(2, dtype=torch.int32, device=x.device) \
        if with_stats else None
    fn = getattr(build.library(build.KERNELS[name]), f"pcilt_gemv_fused_{dt}")
    _launch(name, fn, x, _ptr(x), _ptr(tables), _ptr(out), _ptr(stats), B, G,
            O, pw, spec.bits, spec.zero_point, _host_scale(scale), seg_stride,
            layer_off, int(with_stats))
    return (out, *_stats_out(stats)) if with_stats else out


def pcilt_fused_gemv(x: torch.Tensor, tables: torch.Tensor, spec: QuantSpec,
                     scale, group: int) -> torch.Tensor:
    """x ``[B, n]`` float32, tables ``[G, V, O]`` (``n == G * group``) ->
    ``[B, O]`` in the table dtype: quantize, pack and fetch in one launch."""
    G, V, O = tables.shape
    _check_gemv(x, G, V, spec, group, "G*group")
    if _on_cpu(x, tables):
        return fused_gemv_plain(x, tables, spec, scale, group)
    return _launch_gemv("fused_gemv", x, tables, G, O, group, V * O, 0, spec,
                        scale, False)


def pcilt_fused_gemv_stacked(x: torch.Tensor, tables: torch.Tensor, layer: int,
                             spec: QuantSpec, scale, group: int,
                             with_stats: bool = False):
    """x ``[B, n]`` float32, tables ``[L, G, V, O]`` (``n == G * group``),
    ``layer`` a host int -> ``[B, O]`` in the table dtype; with
    ``with_stats`` also the int32 saturation count and float32
    ``max|x|/scale`` (0-d tensors on the device)."""
    L, G, V, O = tables.shape
    _check_gemv(x, G, V, spec, group, "G*group")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside the stack of {L}")
    if _on_cpu(x, tables):
        return gemv_stacked_plain(x, tables, layer, spec, scale, group,
                                  with_stats)
    return _launch_gemv("gemv_stacked", x, tables, G, O, group, V * O,
                        layer * G * V * O, spec, scale, with_stats)


def pcilt_fused_gemv_paired(x: torch.Tensor, tables: torch.Tensor,
                            spec: QuantSpec, scale, group: int,
                            with_stats: bool = False):
    """x ``[B, n]`` float32, paired tables ``[G2, V2, O]`` (``n == G2 * 2 *
    group``, ``V2 = (2**(bits*group))**2``) -> ``[B, O]``: each fetch
    covers two adjacent segments (the caller pads x over an odd-G phantom
    segment).  ``with_stats`` as for the stacked GEMV."""
    G2, V2, O = tables.shape
    _check_gemv(x, G2, V2, spec, 2 * group, "G2*2*group")
    if _on_cpu(x, tables):
        return gemv_paired_plain(x, tables, spec, scale, group, with_stats)
    return _launch_gemv("gemv_paired", x, tables, G2, O, 2 * group, V2 * O,
                        0, spec, scale, with_stats)


def pcilt_fused_gemv_paired_stacked(x: torch.Tensor, tables: torch.Tensor,
                                    layer: int, spec: QuantSpec, scale,
                                    group: int, with_stats: bool = False):
    """x ``[B, n]`` float32, segment-major paired tables ``[G2, L, V2, O]``
    (``n == G2 * 2 * group``), ``layer`` a host int -> ``[B, O]``: the
    paired decode fetch.  Segment ``g`` of layer ``l`` starts at element
    ``(g * L + l) * V2 * O``; the stack is read in place."""
    G2, L, V2, O = tables.shape
    _check_gemv(x, G2, V2, spec, 2 * group, "G2*2*group")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside the stack of {L}")
    if _on_cpu(x, tables):
        return gemv_paired_stacked_plain(x, tables, layer, spec, scale, group,
                                         with_stats)
    return _launch_gemv("gemv_paired_stacked", x, tables, G2, O, 2 * group,
                        L * V2 * O, layer * V2 * O, spec, scale, with_stats)


def gemv_plan_plain(x, tables, plan_idx, spec: QuantSpec, scale,
                    group: int):
    """Plain version of the plan GEMV: gather ``x`` by ``plan_idx [G,
    group]``, give the ``-1`` slots 0.0 (the zero point's code, as the
    kernel does), then quantize, pack and fetch over ``[G, V, O]``."""
    G, V, O = tables.shape
    idx = plan_idx.long().reshape(-1)
    xg = torch.where(idx >= 0, x[:, idx.clamp_min(0)],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    return _gemv_plain(xg, tables.reshape(G * V, O),
                       lambda off: dense_rows(off, V), spec, scale, group,
                       False)


#: plan tensor -> (its version, its largest entry): a plan's bound is read
#: from the device once, not on every call
_PLAN_MAX = WeakIdKeyDictionary()


def _plan_max(plan_idx: torch.Tensor) -> int:
    seen = _PLAN_MAX.get(plan_idx)
    if seen is None or seen[0] != plan_idx._version:
        seen = (plan_idx._version, int(plan_idx.max()))
        _PLAN_MAX[plan_idx] = seen
    return seen[1]


def pcilt_fused_gemv_plan(x: torch.Tensor, tables: torch.Tensor,
                          plan_idx: torch.Tensor, spec: QuantSpec, scale,
                          group: int) -> torch.Tensor:
    """x ``[B, n]`` float32 (any ``n``), tables ``[G, V, O]``, plan_idx
    ``[G, group]`` int32 (entries in ``[-1, n)``; ``-1`` = unused slot) ->
    ``[B, O]`` in the table dtype: the fused GEMV of a generalized
    ``SegmentPlan``, which gathers ``x`` by the plan before it quantizes,
    packs and fetches.  The plan's bounds are checked once per tensor."""
    B, n = x.shape
    G, V, O = tables.shape
    if tuple(plan_idx.shape) != (G, group):
        raise ValueError(f"plan_idx shape {tuple(plan_idx.shape)} != (G, "
                         f"group) = ({G}, {group}) (tables "
                         f"{tuple(tables.shape)})")
    if plan_idx.dtype != torch.int32:
        raise TypeError(f"plan_idx must be int32, got {plan_idx.dtype}")
    _check_gemv(x, G, V, spec, group)
    if plan_idx.numel() and _plan_max(plan_idx) >= n:
        raise ValueError(f"plan_idx reads position {_plan_max(plan_idx)} of "
                         f"an x of width {n}")
    if _on_cpu(x, tables, plan_idx):
        return gemv_plan_plain(x, tables, plan_idx, spec, scale, group)
    dt = _check_launch("pcilt_fused_gemv_plan", x, tables, plan_idx)
    if B * G * 4 > 227 * 1024:
        raise ValueError(f"B*G = {B * G} offsets exceed the shared memory "
                         f"of one block")
    out = torch.empty((B, O), dtype=tables.dtype, device=x.device)
    fn = getattr(build.library(build.KERNELS["gemv_plan"]),
                 f"pcilt_gemv_plan_{dt}")
    _launch("gemv_plan", fn, x, _ptr(x), _ptr(tables), _ptr(out),
            _ptr(plan_idx), B, G, O, n, group, spec.bits, spec.zero_point,
            _host_scale(scale))
    return out


# ----------------------------------------------------------------------------
# Fused depthwise conv1d
# ----------------------------------------------------------------------------


def dwconv1d_plain(xp, tables, spec: QuantSpec, scale, k: int,
                   with_stats: bool = False):
    """Plain version of the dwconv kernel over the time-padded signal."""
    s = torch.as_tensor(_host_scale(scale), dtype=xp.dtype, device=xp.device)
    codes, count, ratio = quantize_with_stats(xp, spec, s)
    To = xp.shape[1] - k + 1
    c = codes.to(torch.int32)
    off = sum(c[:, j:j + To] << (j * spec.bits) for j in range(k))
    out = pcilt_dwconv1d_ref(off, tables)
    return (out, count, ratio) if with_stats else out


def pcilt_fused_dwconv1d(x: torch.Tensor, tables: torch.Tensor,
                         spec: QuantSpec, scale, k: int,
                         padding: str = "CAUSAL", with_stats: bool = False):
    """x ``[B, T, C]`` float32, tables ``[C, V]`` (``V = 2**(bits*k)``)
    -> ``[B, To, C]`` in the table dtype (plus the saturation stats of the
    signal with ``with_stats``).  The only host-side work is the time pad
    of the signal (none for ``"VALID"``)."""
    B, T, C = x.shape
    C2, V = tables.shape
    if C != C2:
        raise ValueError(f"x channel dim {C} != tables channel dim {C2} "
                         f"(x {tuple(x.shape)}, tables {tuple(tables.shape)})")
    if V != 1 << (spec.bits * k):
        raise ValueError(f"tables value axis {V} != 2**(bits*k) = "
                         f"{1 << (spec.bits * k)}")
    lo, hi = _dwconv_pads(k, padding)
    xp = F.pad(x, (0, 0, lo, hi)) if lo or hi else x
    Tp = xp.shape[1]
    if Tp < k or B < 1:
        raise ValueError(f"signal of {T} steps is too short for {k} taps "
                         f"with padding {padding!r}")
    if _on_cpu(xp, tables):
        return dwconv1d_plain(xp, tables, spec, scale, k, with_stats)
    dt = _check_launch("pcilt_fused_dwconv1d", xp, tables)
    out = torch.empty((B, Tp - k + 1, C), dtype=tables.dtype, device=x.device)
    stats = torch.zeros(2, dtype=torch.int32, device=x.device) \
        if with_stats else None
    fn = getattr(build.library("dwconv1d"), f"pcilt_dwconv1d_{dt}")
    _launch("dwconv1d", fn, xp, _ptr(xp), _ptr(tables), _ptr(out),
            _ptr(stats), B, Tp, C, V, k, spec.bits, spec.zero_point,
            _host_scale(scale), int(with_stats))
    return (out, *_stats_out(stats)) if with_stats else out


def pcilt_dwconv1d(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, T, C]`` int32 (packed by the caller), tables ``[C, V]``
    -> ``[B, T, C]`` in the table dtype: one fetch per output."""
    if offsets.dim() != 3:
        raise ValueError(f"offsets must be [B, T, C], got "
                         f"{tuple(offsets.shape)}")
    C, V = tables.shape
    if offsets.shape[-1] != C:
        raise ValueError(f"offsets channel dim {offsets.shape[-1]} != tables "
                         f"channel dim {C} (offsets {tuple(offsets.shape)}, "
                         f"tables {tuple(tables.shape)})")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if _on_cpu(offsets, tables):  # the plain version: kernels.ref's
        return pcilt_dwconv1d_ref(offsets, tables)
    dt = _check_tables("pcilt_dwconv1d", tables, offsets)
    out = torch.empty(offsets.shape, dtype=tables.dtype,
                      device=offsets.device)
    if out.numel():
        fn = getattr(build.library("dwconv1d"), f"pcilt_dwconv1d_host_{dt}")
        _launch("dwconv1d_host", fn, offsets, _ptr(offsets), _ptr(tables),
                _ptr(out), out.numel(), C, V)
    return out


# ----------------------------------------------------------------------------
# Shared-pool fused GEMV
# ----------------------------------------------------------------------------


def shared_gemv_plain(x, pool, seg_idx, spec: QuantSpec, scale, group: int):
    """Plain version of the shared-pool kernel; a pointer outside
    ``[0, X)`` contributes nothing."""
    s = torch.as_tensor(_host_scale(scale), dtype=x.dtype, device=x.device)
    off = pack_offsets(quantize(x, spec, s), spec.bits, group)
    X, V, O = pool.shape
    return fetch_sum(pool_rows(off, seg_idx, X, V), pool.reshape(X * V, O))


def pcilt_shared_gemv(x: torch.Tensor, pool: torch.Tensor,
                      seg_idx: torch.Tensor, spec: QuantSpec, scale,
                      group: int) -> torch.Tensor:
    """x ``[B, n]`` float32, pool ``[X, V, O]``, seg_idx ``[G]`` int32
    (``n == G * group``) -> ``[B, O]`` in the pool dtype."""
    B, n = x.shape
    X, V, O = pool.shape
    G = int(seg_idx.shape[-1])
    if seg_idx.dim() != 1 or seg_idx.dtype != torch.int32:
        raise TypeError(f"seg_idx must be a 1-d int32 tensor, got "
                        f"{seg_idx.dtype} {tuple(seg_idx.shape)}")
    if n != G * group:
        raise ValueError(f"x trailing dim {n} != G*group = {G}*{group} "
                         f"(x {tuple(x.shape)}, seg_idx {tuple(seg_idx.shape)})")
    if V != 1 << (spec.bits * group):
        raise ValueError(f"pool value axis {V} != 2**(bits*group) = "
                         f"{1 << (spec.bits * group)}")
    if B < 1:
        raise ValueError("empty batch")
    if _on_cpu(x, pool, seg_idx):
        return shared_gemv_plain(x, pool, seg_idx, spec, scale, group)
    dt = _check_launch("pcilt_shared_gemv", x, pool, seg_idx)
    if B * G * 4 > 227 * 1024:
        raise ValueError(f"B*G = {B * G} offsets exceed the shared memory "
                         f"of one block")
    out = torch.empty((B, O), dtype=pool.dtype, device=x.device)
    fn = getattr(build.library("shared_gemv"), f"pcilt_shared_gemv_{dt}")
    _launch("shared_gemv", fn, x, _ptr(x), _ptr(seg_idx), _ptr(pool),
            _ptr(out), B, G, X, V, O, group, spec.bits, spec.zero_point,
            _host_scale(scale))
    return out


# ----------------------------------------------------------------------------
# Host-packed GEMV and conv2d
# ----------------------------------------------------------------------------


def _launch_gemv_host(name: str, offsets: torch.Tensor,
                      tables: torch.Tensor) -> torch.Tensor:
    G, V, O = tables.shape
    if offsets.dtype != torch.int32:
        raise TypeError(f"{name}: offsets must be int32, got {offsets.dtype}")
    if offsets.shape[-1] != G:
        raise ValueError(f"{name}: offsets segment dim {offsets.shape[-1]} "
                         f"!= tables segment dim {G} (offsets "
                         f"{tuple(offsets.shape)}, tables "
                         f"{tuple(tables.shape)})")
    flat = offsets.reshape(-1, G)
    M = flat.shape[0]
    if M < 1:
        raise ValueError(f"{name}: no rows")
    if _on_cpu(offsets, tables):
        out = pcilt_gemv_ref(flat, tables)
    else:
        dt = _check_tables(name, tables, offsets)
        out = torch.empty((M, O), dtype=tables.dtype, device=tables.device)
        fn = getattr(build.library("gemv_host"), f"pcilt_gemv_host_{dt}")
        _launch(name, fn, tables, _ptr(offsets), _ptr(tables), _ptr(out), M,
                G, V, O)
    return out.reshape(*offsets.shape[:-1], O)


def pcilt_gemv(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[M, G]`` int32 (packed by the caller), tables ``[G, V, O]``
    -> ``[M, O]`` in the table dtype: ``sum_g T[g, off[m, g]]``."""
    if offsets.dim() != 2:
        raise ValueError(f"offsets must be [M, G], got {tuple(offsets.shape)}")
    return _launch_gemv_host("gemv_host", offsets, tables)


def pcilt_conv2d(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, Ho, Wo, G]`` int32, tables ``[G, V, O]`` ->
    ``[B, Ho, Wo, O]``: the host-packed conv fetch, the GEMV kernel over the
    flattened pixels."""
    if offsets.dim() != 4:
        raise ValueError(f"offsets must be [B, Ho, Wo, G], got "
                         f"{tuple(offsets.shape)}")
    return _launch_gemv_host("conv2d_host", offsets, tables)


# ----------------------------------------------------------------------------
# Fused and shared-pool conv2d
# ----------------------------------------------------------------------------


def _conv_plain_offsets(xp, spec: QuantSpec, scale, group: int, kh: int,
                        kw: int, stride: int) -> torch.Tensor:
    """The conv kernels' activation side on the host, over the padded image
    and at the kernel's float32 scale -> ``[B*Ho*Wo, G]`` int32."""
    s = torch.as_tensor(_host_scale(scale), dtype=xp.dtype, device=xp.device)
    off = conv_offsets(xp, spec, s, group, kh, kw, stride, "VALID")
    return off.reshape(-1, off.shape[-1])


def fused_conv2d_plain(xp, tables, spec: QuantSpec, scale, group: int,
                       kh: int, kw: int, stride: int):
    """Plain version of the fused conv kernel over the padded image."""
    return pcilt_gemv_ref(_conv_plain_offsets(xp, spec, scale, group, kh, kw,
                                              stride), tables)


def shared_conv2d_plain(xp, pool, seg_idx, spec: QuantSpec, scale,
                        group: int, kh: int, kw: int, stride: int):
    """Plain version of the shared-pool conv kernel over the padded image;
    a pointer outside ``[0, X)`` adds nothing."""
    X, V, O = pool.shape
    off = _conv_plain_offsets(xp, spec, scale, group, kh, kw, stride)
    return fetch_sum(pool_rows(off, seg_idx, X, V), pool.reshape(X * V, O))


def _conv_geometry(name, x, G, V, spec, group, kh, kw, stride, padding):
    """Pad the float image (the only host-side work) and check the shapes:
    -> ``(xp, Ho, Wo)``."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    if stride < 1:
        raise ValueError(f"{name}: stride must be >= 1, got {stride}")
    xp = pad_nhwc(x, _conv_pads(x, kh, kw, stride, padding))
    B, Hp, Wp, C = xp.shape
    Ho = (Hp - kh) // stride + 1
    Wo = (Wp - kw) // stride + 1
    if B < 1 or Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: image {tuple(x.shape)} gives no output "
                         f"for a {kh}x{kw} filter with padding {padding!r}")
    if G * group < kh * kw * C:
        raise ValueError(f"{name}: G*group = {G}*{group} does not cover the "
                         f"patch length kh*kw*C = {kh * kw * C}")
    if V != 1 << (spec.bits * group):
        raise ValueError(f"{name}: value axis {V} != 2**(bits*group) = "
                         f"{1 << (spec.bits * group)}")
    return xp, Ho, Wo


#: the staged design's tiling (``namespace staged`` of pcilt_conv2d.cu; the
#: library's own values are checked against these at its first launch):
#: pixels and columns a block, slice slots, offset slots, the bytes from one
#: slice row to the next, the largest V (offsets are bytes)
STAGED_PIX_TILE, STAGED_COL_TILE = 1024, 32
STAGED_STAGES, STAGED_OFF_RING, STAGED_ROW_PITCH = 4, 8, 256
STAGED_MAX_V = 256
#: dynamic shared memory one block may use on an H100
SMEM_LIMIT = 227 * 1024


def staged_smem_bytes(itemsize: int) -> int:
    """Shared memory of a staged block: ``STAGED_STAGES`` table slices of
    ``STAGED_COL_TILE`` columns, side by side in rows of
    ``STAGED_ROW_PITCH`` bytes, ``STAGED_MAX_V`` rows a block, then
    ``STAGED_OFF_RING`` slots of ``STAGED_PIX_TILE`` offset bytes and of a
    ``STAGED_MAX_V``-byte row mask."""
    per_row = STAGED_ROW_PITCH // (STAGED_COL_TILE * itemsize)
    blocks = -(-STAGED_STAGES // per_row)
    return (blocks * STAGED_MAX_V * STAGED_ROW_PITCH
            + STAGED_OFF_RING * (STAGED_PIX_TILE + STAGED_MAX_V))


def conv_variant(V: int, itemsize: int) -> str:
    """The conv design for tables of value axis ``V`` and ``itemsize``-byte
    cells: ``"staged"`` while every offset fits a byte and the ring fits a
    block's shared memory, else ``"direct"``."""
    if V <= STAGED_MAX_V and staged_smem_bytes(itemsize) <= SMEM_LIMIT:
        return "staged"
    return "direct"


def staged_tiles(P: int, O: int):
    """``(pixel tiles, column tiles)`` of the staged grid over ``P`` output
    pixels and ``O`` columns; the grid has their product of blocks."""
    return -(-P // STAGED_PIX_TILE), -(-O // STAGED_COL_TILE)


def staged_block_tile(i: int, P: int, O: int):
    """Block ``i``'s ``((p0, p1), (o0, o1))``: pixel tile ``i % n_ptiles``
    of column tile ``i // n_ptiles`` (the blocks resident together share a
    column tile), clipped to ``P`` and ``O``."""
    n_ptiles, _ = staged_tiles(P, O)
    p0 = (i % n_ptiles) * STAGED_PIX_TILE
    o0 = (i // n_ptiles) * STAGED_COL_TILE
    return ((p0, min(P, p0 + STAGED_PIX_TILE)),
            (o0, min(O, o0 + STAGED_COL_TILE)))


def conv_codes_plain(xp: torch.Tensor, spec: QuantSpec, scale) -> torch.Tensor:
    """Plain version of the staged design's pre-pass: the padded image
    ``[B, Hp, Wp, C]`` float32 -> its codes ``[B, C, Hp, Wp]`` uint8, at the
    kernel's float32 scale."""
    s = torch.as_tensor(_host_scale(scale), dtype=xp.dtype, device=xp.device)
    return quantize(xp, spec, s).permute(0, 3, 1, 2).contiguous()


def _conv_codes(xp: torch.Tensor, spec: QuantSpec, scale) -> torch.Tensor:
    """The pre-pass: its kernel on a CUDA tensor, its plain version on the
    CPU (not counted: it is half of one conv launch)."""
    if _on_cpu(xp):
        return conv_codes_plain(xp, spec, scale)
    if spec.bits > 8:
        raise ValueError(f"codes of {spec.bits} bits do not fit a byte")
    if xp.dtype != torch.float32 or not xp.is_contiguous():
        raise ValueError(f"conv2d codes: the padded image must be a "
                         f"contiguous float32 tensor, got {xp.dtype} with "
                         f"strides {xp.stride()}")
    B, Hp, Wp, C = xp.shape
    codes = torch.empty((B, C, Hp, Wp), dtype=torch.uint8, device=xp.device)
    fn = build.library("conv2d").pcilt_conv2d_codes_f32
    _call("conv2d codes", fn, xp, _ptr(xp), _ptr(codes), B, Hp, Wp, C,
          spec.bits, spec.zero_point, _host_scale(scale))
    return codes


_STAGED_CHECKED = []


def _check_staged_config() -> None:
    """The library's staged tiling must be this module's mirror of it."""
    if _STAGED_CHECKED:
        return
    cfg = (ctypes.c_int * 6)()
    build.library("conv2d").pcilt_conv2d_staged_config(cfg)
    mine = (STAGED_PIX_TILE, STAGED_COL_TILE, STAGED_STAGES, STAGED_OFF_RING,
            STAGED_ROW_PITCH, STAGED_MAX_V)
    if tuple(cfg) != mine:
        raise RuntimeError(f"pcilt_conv2d.cu's staged tiling {tuple(cfg)} "
                           f"differs from kernels.ops' {mine}")
    _STAGED_CHECKED.append(True)


def _launch_conv(name, xp, tab, seg_idx, X, spec, scale, group, kh, kw,
                 stride, Ho, Wo, variant=None):
    B, Hp, Wp, C = xp.shape
    G = int(seg_idx.shape[0]) if seg_idx is not None else tab.shape[0]
    _, V, O = tab.shape
    others = () if seg_idx is None else (seg_idx,)
    dt = _check_launch(name, xp, tab, *others)
    fits = conv_variant(V, tab.element_size())
    variant = variant or fits
    if variant not in CONV_VARIANT_LAUNCHES:
        raise ValueError(f"{name}: unknown conv variant {variant!r}")
    if variant == "staged" and fits != "staged":
        raise ValueError(f"{name}: a V = {V} slice cannot be staged "
                         f"(V <= {STAGED_MAX_V} and "
                         f"{staged_smem_bytes(tab.element_size())} B of "
                         f"shared memory <= {SMEM_LIMIT} B needed)")
    out = torch.empty((B, Ho, Wo, O), dtype=tab.dtype, device=xp.device)
    lib = build.library("conv2d")
    if variant == "staged":
        _check_staged_config()
        codes = _conv_codes(xp, spec, scale)
        fn = getattr(lib, f"pcilt_{name}_staged_{dt}")
        _launch(name, fn, xp, _ptr(codes), _ptr(tab), _ptr(seg_idx),
                _ptr(out), B, C, Hp, Wp, Ho, Wo, kh, kw, stride, G, X, V, O,
                group, spec.bits)
    else:
        fn = getattr(lib, f"pcilt_{name}_{dt}")
        _launch(name, fn, xp, _ptr(xp), _ptr(tab), _ptr(seg_idx), _ptr(out),
                B, Hp, Wp, C, Ho, Wo, kh, kw, stride, G, X, V, O, group,
                spec.bits, spec.zero_point, _host_scale(scale))
    CONV_VARIANT_LAUNCHES[variant] += 1
    return out


def pcilt_fused_conv2d(x: torch.Tensor, tables: torch.Tensor,
                       spec: QuantSpec, scale, group: int, kh: int, kw: int,
                       stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """x ``[B, H, W, C]`` float32 NHWC, tables ``[G, V, O]`` ->
    ``[B, Ho, Wo, O]`` in the table dtype.  The only host-side work is the
    spatial zero pad of the float image (SAME by :func:`conv_same_pads`);
    quantize, im2col and pack run on the card, so neither the float patches
    nor the offsets reach device memory.  ``G * group >= kh*kw*C``: the
    alignment slots take code 0 against zero-weight table rows."""
    return _fused_conv2d(x, tables, spec, scale, group, kh, kw, stride,
                         padding)


def _fused_conv2d(x, tables, spec: QuantSpec, scale, group: int, kh: int,
                  kw: int, stride: int = 1, padding: str = "SAME",
                  variant=None):
    """:func:`pcilt_fused_conv2d`, with ``variant`` forcing a design on a
    CUDA tensor."""
    G, V, O = tables.shape
    xp, Ho, Wo = _conv_geometry("pcilt_fused_conv2d", x, G, V, spec, group,
                                kh, kw, stride, padding)
    if _on_cpu(xp, tables):
        out = fused_conv2d_plain(xp, tables, spec, scale, group, kh, kw,
                                 stride)
        return out.reshape(xp.shape[0], Ho, Wo, O)
    return _launch_conv("fused_conv2d", xp, tables, None, 0, spec, scale,
                        group, kh, kw, stride, Ho, Wo, variant)


def pcilt_shared_conv2d(x: torch.Tensor, pool: torch.Tensor,
                        seg_idx: torch.Tensor, spec: QuantSpec, scale,
                        group: int, kh: int, kw: int, stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """x ``[B, H, W, C]`` float32 NHWC, pool ``[X, V, O]``, seg_idx ``[G]``
    int32 -> ``[B, Ho, Wo, O]`` in the pool dtype: the fused conv with
    ``T[g]`` replaced by ``pool[seg_idx[g]]``; a pointer outside ``[0, X)``
    adds nothing.  The pool is read in place (no transpose)."""
    return _shared_conv2d(x, pool, seg_idx, spec, scale, group, kh, kw,
                          stride, padding)


def _shared_conv2d(x, pool, seg_idx, spec: QuantSpec, scale, group: int,
                   kh: int, kw: int, stride: int = 1, padding: str = "SAME",
                   variant=None):
    """:func:`pcilt_shared_conv2d`, with ``variant`` forcing a design on a
    CUDA tensor."""
    X, V, O = pool.shape
    if seg_idx.dim() != 1 or seg_idx.dtype != torch.int32:
        raise TypeError(f"seg_idx must be a 1-d int32 tensor, got "
                        f"{seg_idx.dtype} {tuple(seg_idx.shape)}")
    G = int(seg_idx.shape[0])
    xp, Ho, Wo = _conv_geometry("pcilt_shared_conv2d", x, G, V, spec, group,
                                kh, kw, stride, padding)
    if _on_cpu(xp, pool, seg_idx):
        out = shared_conv2d_plain(xp, pool, seg_idx, spec, scale, group, kh,
                                  kw, stride)
        return out.reshape(xp.shape[0], Ho, Wo, O)
    return _launch_conv("shared_conv2d", xp, pool, seg_idx, X, spec, scale,
                        group, kh, kw, stride, Ho, Wo, variant)
