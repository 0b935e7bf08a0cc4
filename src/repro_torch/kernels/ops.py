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
neither falls back to the other.  Both designs take a segment shard of a
mesh (``seg_offset``, ``n_total``: its segments' place in the global
padded patch); the staged pre-pass then quantizes only the channels its
patch positions touch (:func:`conv_code_channels`).

The fused GEMVs (kernels 1 and 8-11, ``csrc/pcilt_gemv_stacked.cu``) also
come in two designs: ``"split"`` (the segment loop split over the warps of
a block and the blocks of a thread-block cluster, summed in a fixed order)
and ``"direct"`` (one block per 128 columns walks every segment).  Every
launch takes ``"split"``; :func:`gemv_variant` mirrors its split and
:data:`GEMV_VARIANT_LAUNCHES` counts which design ran.  ``_launch_gemv``
takes ``variant=``, and :func:`_gemv_forced` forces a design for the
launches inside it (tests and ``chip_smoke.py``); neither falls back to the
other.

The shared-pool GEMV (kernel 3, ``csrc/pcilt_shared_gemv.cu``) comes in a
``"split"`` design (4 KB row pieces, the segment loop split over a
thread-block cluster; :func:`shared_gemv_variant` mirrors it) and the kept
``"direct"`` one; the host-packed dwconv (kernel 12,
``csrc/pcilt_dwconv1d.cu``) in a ``"staged"`` design (the table slice in
shared memory, the offsets streamed; :func:`dwconv_host_tiling` mirrors it)
and the kept ``"direct"`` one.  :data:`SHARED_GEMV_VARIANT_LAUNCHES` and
:data:`DWCONV_HOST_VARIANT_LAUNCHES` count which ran; ``_shared_gemv`` and
``_dwconv1d_host`` take ``variant=`` to force either on a CUDA tensor;
neither falls back to the other.

The fused dwconv (kernel 2, ``csrc/pcilt_dwconv1d.cu``) comes in a
``"tiled"`` design (a grid of channel tiles and output rows that
:func:`dwconv_tiled_grid` mirrors, its counters reduced across blocks
without a pre-zeroed buffer, so no fill kernel runs before it; ``k <= 8``)
and the kept ``"direct"`` one;
:data:`DWCONV_VARIANT_LAUNCHES` counts which ran, ``_fused_dwconv1d`` takes
``variant=`` and :func:`_dwconv_forced` forces a design for the launches
inside it.  The host-packed GEMV and conv (kernels 6 and 7, one body in
``csrc/pcilt_gemv.cu``) come in a ``"staged"`` design (kernel 4's staged
fetch over the caller's offsets; ``V <= 256`` and at least one row tile)
and the kept ``"direct"`` one: :func:`gemv_host_variant` chooses,
:func:`gemv_host_block_tile` mirrors the staged grid,
:data:`GEMV_HOST_VARIANT_LAUNCHES` counts, and ``_gemv_host`` /
``_conv2d_host`` take ``variant=``.  Neither falls back to the other.

Every launch that has a choice of design consults the design cache
(``kernels.autotune``) before its heuristic: a forced design (``variant=``,
:func:`_gemv_forced`, :func:`_dwconv_forced`) wins, then the cache's
recorded design for the launch's shape key, then the heuristic above.  The
``*_candidates`` functions list the designs whose guards admit a shape, the
heuristic's first; with ``autotune=True`` (or ``REPRO_PCILT_AUTOTUNE=1``) a
miss times them on the card and records the winner.  The design of each
launch shape is memoised in process (``autotune.MEMO``), so a warm launch
pays one dict lookup.

:func:`pcilt_crc32` is the CRC-32 of the tables' integrity record and
checks (``csrc/pcilt_crc32.cu``): ``zlib.crc32`` of each of a list of
streams (a contiguous tensor's bytes, or byte ranges of it), computed on
the card for CUDA tensors (one launch counted for all the streams, one
read back of their words) and by the same chunk and combine arithmetic
(``kernels.ref.crc32_plain``) for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.offsets import pack_offsets
from repro_torch.core.quantization import QuantSpec, quantize, quantize_with_stats
from repro_torch.core.lut_layers import (_conv_pads, _dwconv_pads,
                                         im2col, pad_nhwc)
from . import autotune as atn
from . import build
from .ref import (CRC_CHUNK_BYTES, CRC_LANE_BYTES, CRC_LEVELS, crc32_finish,
                  crc32_plain, crc_operators, dense_rows, fetch_sum,
                  fetch_sum_sliced, pcilt_dwconv1d_ref, pcilt_gemv_ref,
                  pool_rows)

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
           "staged_tiles", "staged_block_tile", "conv_codes_plain",
           "conv_code_channels",
           "GEMV_VARIANT_LAUNCHES", "GemvSplit", "gemv_variant",
           "gemv_smem_bytes", "SHARED_GEMV_VARIANT_LAUNCHES", "SharedSplit",
           "shared_gemv_variant", "shared_gemv_smem_bytes",
           "shared_gemv_slices", "DWCONV_HOST_VARIANT_LAUNCHES",
           "DwconvTiling", "dwconv_host_variant", "dwconv_host_tiling",
           "DWCONV_VARIANT_LAUNCHES", "GEMV_HOST_VARIANT_LAUNCHES",
           "gemv_host_variant", "gemv_host_smem_bytes", "gemv_host_tiles",
           "gemv_host_block_tile", "gemv_host_plain", "dwconv_variant",
           "DwTiledGrid", "dwconv_tiled_grid", "pcilt_crc32",
           "CRC_DEVICE_LAUNCHES", "crc32_plain", "gemv_candidates",
           "dwconv_candidates", "shared_gemv_candidates", "conv_candidates",
           "gemv_host_candidates", "dwconv_host_candidates"]

#: kernel name -> number of launches of its CUDA kernel in this process
LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}

_TABLE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


#: conv design -> number of fused/shared conv2d calls it served on CUDA
CONV_VARIANT_LAUNCHES: Dict[str, int] = {"staged": 0, "direct": 0}

#: fused GEMV design -> number of fused GEMV launches it served on CUDA
GEMV_VARIANT_LAUNCHES: Dict[str, int] = {"split": 0, "direct": 0}

#: shared-pool GEMV design -> number of its launches on CUDA
SHARED_GEMV_VARIANT_LAUNCHES: Dict[str, int] = {"split": 0, "direct": 0}

#: host-packed dwconv design -> number of its launches on CUDA
DWCONV_HOST_VARIANT_LAUNCHES: Dict[str, int] = {"staged": 0, "direct": 0}

#: fused dwconv design -> number of its launches on CUDA
DWCONV_VARIANT_LAUNCHES: Dict[str, int] = {"tiled": 0, "direct": 0}

#: host-packed GEMV / conv design -> number of its launches on CUDA
GEMV_HOST_VARIANT_LAUNCHES: Dict[str, int] = {"staged": 0, "direct": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, CONV_VARIANT_LAUNCHES, GEMV_VARIANT_LAUNCHES,
                   SHARED_GEMV_VARIANT_LAUNCHES,
                   DWCONV_HOST_VARIANT_LAUNCHES, DWCONV_VARIANT_LAUNCHES,
                   GEMV_HOST_VARIANT_LAUNCHES, CRC_DEVICE_LAUNCHES):
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


def _choose(key, dev: torch.device, dtype, candidates, bench,
            autotune: Optional[bool]) -> str:
    """The design of one launch at ``key = (kernel, dimension names, their
    values)``: the memoised one (a recorded or tuned design; or the
    heuristic's, unless this call asks to tune); else the cache's recorded
    design when ``candidates()`` (the admitted designs, the heuristic's
    first) holds it; else, with tuning asked (``autotune``, or
    ``REPRO_PCILT_AUTOTUNE`` read at a shape's first launch) and a card
    (or an injected timer) to time on, the tuned winner; else the
    heuristic.  ``bench(design)`` returns a closure that runs one launch in
    that design.  A memoised launch builds no string and reads no
    environment: one dict lookup."""
    kernel, names, values = key
    mkey = (kernel, dev, dtype, values)
    got = atn.MEMO.get(mkey)
    if got is not None and (got[1] or autotune is not True):
        return got[0]
    cands = candidates()
    skey = atn.shape_key(kernel, dtype=dtype, backend=atn.backend_name(dev),
                         **dict(zip(names, values)))
    design = atn.lookup_design(skey)
    hit = design in cands
    if not hit:
        design = cands[0]
        if atn.autotune_enabled(autotune) and (
                dev.type == "cuda" or atn.injected_timer() is not None):
            design, hit = atn.tune_design(skey, cands, bench), True
    atn.MEMO[mkey] = (design, hit)
    return design


def _tune_plain(key, dev, dtype, candidates, plain,
                autotune: Optional[bool]) -> None:
    """On the CPU, where every design is the plain version: with tuning
    asked, the cache is consulted (and with an injected timer, tuned on
    ``plain``); nothing else."""
    if atn.autotune_enabled(autotune):
        _choose(key, dev, dtype, candidates, lambda d: plain, autotune)


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


#: the split design's constants (the ``k*`` constants of
#: pcilt_gemv_stacked.cu; the library's own are checked against these at
#: its first launch): rows a block, warps a block (at most), segments a
#: load batch, the blocks the split aims for, the largest cluster, the
#: fewest segments a slice, the most lanes a slot, the bytes of
#: neighbouring columns a lane owns
GEMV_ROWS, GEMV_WARPS, GEMV_SEG_BATCH = 4, 4, 4
GEMV_TARGET_BLOCKS, GEMV_MAX_CLUSTER, GEMV_MIN_SEGS = 264, 16, 1
GEMV_MAX_LANES, GEMV_LANE_BYTES = 16, 16


class GemvSplit(NamedTuple):
    """The split design's launch over one call (``split_for`` of
    pcilt_gemv_stacked.cu).  Slot ``s`` of ``cluster * warps * groups``
    sums its slice of the segments for one output tile of ``tile`` columns
    and ``GEMV_ROWS`` rows; the grid is ``tiles * cluster`` by ``chunks``
    blocks."""
    lanes: int    # lanes of a slot
    groups: int   # slots (slices) a warp
    warps: int    # warps a block
    cluster: int  # blocks a cluster
    tile: int     # columns an output tile
    tiles: int    # output tiles
    chunks: int   # row chunks of GEMV_ROWS


@functools.lru_cache(maxsize=None)
def gemv_variant(B: int, G: int, O: int, itemsize: int) -> GemvSplit:
    """The split of a fused GEMV over ``B`` rows, ``G`` segments and ``O``
    columns of ``itemsize``-byte cells: a lane owns ``GEMV_LANE_BYTES`` of
    columns, a slot as many lanes as cover O (at most ``GEMV_MAX_LANES``;
    a narrow O puts several slots in a warp), and the cluster doubles
    until the grid has ``GEMV_TARGET_BLOCKS`` blocks, but no slice falls
    under ``GEMV_MIN_SEGS`` segments (then the block sheds warps the same
    way).  A function of the shape alone: a plan does not change it."""
    nv = GEMV_LANE_BYTES // itemsize
    lanes = min(GEMV_MAX_LANES, -(-O // nv))
    groups = 32 // lanes
    tile = lanes * nv
    tiles = -(-O // tile)
    chunks = -(-B // GEMV_ROWS)
    cs = 1
    while cs < GEMV_MAX_CLUSTER and tiles * chunks * cs < GEMV_TARGET_BLOCKS:
        cs *= 2
    while cs > 1 and cs * GEMV_WARPS * groups * GEMV_MIN_SEGS > G:
        cs //= 2
    w = GEMV_WARPS
    if cs == 1:
        while w > 1 and w * groups * GEMV_MIN_SEGS > G:
            w //= 2
    return GemvSplit(lanes, groups, w, cs, tile, tiles, chunks)


def gemv_smem_bytes(split: GemvSplit, G: int) -> int:
    """Dynamic shared memory of a split block: the slots' float32 partial
    sums ``[warps * groups, GEMV_ROWS, tile]``, then the int32 offsets of
    the block's segments ``[ceil(G / cluster), GEMV_ROWS]``."""
    return 4 * GEMV_ROWS * (split.warps * split.groups * split.tile
                            + -(-G // split.cluster))


#: a design forced on the fused GEMV launches inside :func:`_gemv_forced`
_GEMV_FORCED: Optional[str] = None


@contextlib.contextmanager
def _gemv_forced(variant: str):
    """Every fused GEMV launched on a CUDA tensor inside the block runs
    ``variant`` (tests and ``chip_smoke.py``); CPU tensors still run the
    plain versions."""
    global _GEMV_FORCED
    if variant not in GEMV_VARIANT_LAUNCHES:
        raise ValueError(f"unknown fused GEMV variant {variant!r}")
    before, _GEMV_FORCED = _GEMV_FORCED, variant
    try:
        yield
    finally:
        _GEMV_FORCED = before


_GEMV_CHECKED = set()


def _check_gemv_split(lib, B: int, G: int, O: int, itemsize: int,
                      split: GemvSplit) -> None:
    """The library's split constants, and its split of this shape, must be
    this module's mirror of them (each shape checked once)."""
    if not _GEMV_CHECKED:
        cfg = (ctypes.c_int * 8)()
        lib.pcilt_gemv_split_config(cfg)
        mine = (GEMV_ROWS, GEMV_WARPS, GEMV_SEG_BATCH, GEMV_TARGET_BLOCKS,
                GEMV_MAX_CLUSTER, GEMV_MIN_SEGS, GEMV_MAX_LANES,
                GEMV_LANE_BYTES)
        if tuple(cfg) != mine:
            raise RuntimeError(f"pcilt_gemv_stacked.cu's split constants "
                               f"{tuple(cfg)} differ from kernels.ops' {mine}")
        _GEMV_CHECKED.add("config")
    key = (split.chunks, G, O, itemsize)
    if key in _GEMV_CHECKED:
        return
    got = (ctypes.c_int * 8)()
    lib.pcilt_gemv_split_plan(B, G, O, itemsize, got)
    mine = (*split, gemv_smem_bytes(split, G))
    if tuple(got) != mine:
        raise RuntimeError(f"pcilt_gemv_stacked.cu splits B {B}, G {G}, O {O}"
                           f" as {tuple(got)}, kernels.ops as {mine}")
    _GEMV_CHECKED.add(key)


def gemv_candidates(B: int, G: int, O: int, itemsize: int) -> List[str]:
    """The fused GEMV designs whose guards admit ``B`` rows of ``G``
    segments and ``O`` columns: ``"split"`` (the heuristic) while a block's
    shared memory and the grid's row chunks fit, ``"direct"`` while the
    ``B * G`` offsets fit one block."""
    split = gemv_variant(B, G, O, itemsize)
    out = []
    if gemv_smem_bytes(split, G) <= SMEM_LIMIT and split.chunks <= 65535:
        out.append("split")
    if B * G * 4 <= SMEM_LIMIT:
        out.append("direct")
    return out or ["split"]


def _launch_gemv(name, x, tables, G, O, pw, seg_stride, layer_off,
                 spec: QuantSpec, scale, with_stats, plan_idx=None,
                 variant=None, key=None, autotune=None):
    """One launch of the fused GEMV kernel: segment ``g`` of the call is the
    ``[V, O]`` table at element ``layer_off + g * seg_stride``; with
    ``plan_idx`` the plan launch (segment ``g`` reads ``x`` by its plan
    row).  ``variant`` (else the forced one, else the design cache's for
    ``key = (kernel, names, values)`` when given, else ``"split"``) picks
    the
    design."""
    others = () if plan_idx is None else (plan_idx,)
    dt = _check_launch(name, x, tables, *others)
    B, n = x.shape
    variant = variant or _GEMV_FORCED or ("split" if key is None else None)
    if variant is None:
        es = tables.element_size()
        variant = _choose(
            key, x.device, tables.dtype,
            lambda: gemv_candidates(B, G, O, es),
            lambda d: lambda: _launch_gemv(
                name, x, tables, G, O, pw, seg_stride, layer_off, spec,
                scale, with_stats, plan_idx, variant=d),
            autotune)
    if variant not in GEMV_VARIANT_LAUNCHES:
        raise ValueError(f"{name}: unknown fused GEMV variant {variant!r}")
    lib = build.library(build.KERNELS[name])
    if variant == "split":
        split = gemv_variant(B, G, O, tables.element_size())
        smem = gemv_smem_bytes(split, G)
        if smem > SMEM_LIMIT or split.chunks > 65535:
            raise ValueError(f"{name}: B = {B}, G = {G} needs {smem} B of "
                             f"shared memory a block (at most {SMEM_LIMIT})"
                             f" and {split.chunks} row chunks (at most "
                             f"65535)")
        _check_gemv_split(lib, B, G, O, tables.element_size(), split)
    elif B * G * 4 > SMEM_LIMIT:
        raise ValueError(f"{name}: B*G = {B * G} offsets exceed the shared "
                         f"memory of one block")
    out = torch.empty((B, O), dtype=tables.dtype, device=x.device)
    stats = torch.zeros(2, dtype=torch.int32, device=x.device) \
        if with_stats else None
    code = 0 if variant == "split" else 1
    if plan_idx is None:
        _launch(name, getattr(lib, f"pcilt_gemv_fused_{dt}"), x, _ptr(x),
                _ptr(tables), _ptr(out), _ptr(stats), B, G, O, pw, spec.bits,
                spec.zero_point, _host_scale(scale), seg_stride, layer_off,
                int(with_stats), code)
    else:
        _launch(name, getattr(lib, f"pcilt_gemv_plan_{dt}"), x, _ptr(x),
                _ptr(tables), _ptr(out), _ptr(plan_idx), B, G, O, n, pw,
                spec.bits, spec.zero_point, _host_scale(scale), code)
    GEMV_VARIANT_LAUNCHES[variant] += 1
    return (out, *_stats_out(stats)) if with_stats else out


#: the dimensions of the fused GEMVs' keys (the reference's), unstacked
#: and stacked
_GEMV_DIMS = ("B", "G", "V", "O", "g", "bits")
_STACKED_DIMS = ("B", "R", "L", "G", "V", "O", "g", "bits")


def _gemv_key(kname, with_stats, names, *values):
    """``(kernel, names, values)`` of a fused GEMV launch: the reference's
    key, the counter-carrying launches under the ``_sat`` family."""
    return (f"{kname}_sat" if with_stats else kname, names, values)


def _gemv_plain_tune(key, x, tables, G, O, plain, autotune):
    _tune_plain(key, x.device, tables.dtype,
                lambda: gemv_candidates(x.shape[0], G, O,
                                        tables.element_size()),
                plain, autotune)
    return plain()


def pcilt_fused_gemv(x: torch.Tensor, tables: torch.Tensor, spec: QuantSpec,
                     scale, group: int, *,
                     autotune: Optional[bool] = None) -> torch.Tensor:
    """x ``[B, n]`` float32, tables ``[G, V, O]`` (``n == G * group``) ->
    ``[B, O]`` in the table dtype: quantize, pack and fetch in one launch.
    ``autotune`` tunes the design on a cache miss (see the module)."""
    G, V, O = tables.shape
    _check_gemv(x, G, V, spec, group, "G*group")
    key = _gemv_key("fused_gemv", False, _GEMV_DIMS, x.shape[0], G, V, O,
                    group, spec.bits)
    if _on_cpu(x, tables):
        return _gemv_plain_tune(
            key, x, tables, G, O,
            lambda: fused_gemv_plain(x, tables, spec, scale, group), autotune)
    return _launch_gemv("fused_gemv", x, tables, G, O, group, V * O, 0, spec,
                        scale, False, key=key, autotune=autotune)


def pcilt_fused_gemv_stacked(x: torch.Tensor, tables: torch.Tensor, layer: int,
                             spec: QuantSpec, scale, group: int, *,
                             autotune: Optional[bool] = None,
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
    key = _gemv_key("fused_gemv_stacked", with_stats, _STACKED_DIMS,
                    x.shape[0], x.shape[0], L, G, V, O, group, spec.bits)
    if _on_cpu(x, tables):
        return _gemv_plain_tune(
            key, x, tables, G, O,
            lambda: gemv_stacked_plain(x, tables, layer, spec, scale, group,
                                       with_stats), autotune)
    return _launch_gemv("gemv_stacked", x, tables, G, O, group, V * O,
                        layer * G * V * O, spec, scale, with_stats, key=key,
                        autotune=autotune)


def pcilt_fused_gemv_paired(x: torch.Tensor, tables: torch.Tensor,
                            spec: QuantSpec, scale, group: int, *,
                            autotune: Optional[bool] = None,
                            with_stats: bool = False):
    """x ``[B, n]`` float32, paired tables ``[G2, V2, O]`` (``n == G2 * 2 *
    group``, ``V2 = (2**(bits*group))**2``) -> ``[B, O]``: each fetch
    covers two adjacent segments (the caller pads x over an odd-G phantom
    segment).  ``with_stats`` as for the stacked GEMV."""
    G2, V2, O = tables.shape
    _check_gemv(x, G2, V2, spec, 2 * group, "G2*2*group")
    key = _gemv_key("fused_gemv_paired", with_stats, _GEMV_DIMS, x.shape[0],
                    G2, V2, O, group, spec.bits)
    if _on_cpu(x, tables):
        return _gemv_plain_tune(
            key, x, tables, G2, O,
            lambda: gemv_paired_plain(x, tables, spec, scale, group,
                                      with_stats), autotune)
    return _launch_gemv("gemv_paired", x, tables, G2, O, 2 * group, V2 * O,
                        0, spec, scale, with_stats, key=key,
                        autotune=autotune)


def pcilt_fused_gemv_paired_stacked(x: torch.Tensor, tables: torch.Tensor,
                                    layer: int, spec: QuantSpec, scale,
                                    group: int, *,
                                    autotune: Optional[bool] = None,
                                    with_stats: bool = False):
    """x ``[B, n]`` float32, segment-major paired tables ``[G2, L, V2, O]``
    (``n == G2 * 2 * group``), ``layer`` a host int -> ``[B, O]``: the
    paired decode fetch.  Segment ``g`` of layer ``l`` starts at element
    ``(g * L + l) * V2 * O``; the stack is read in place."""
    G2, L, V2, O = tables.shape
    _check_gemv(x, G2, V2, spec, 2 * group, "G2*2*group")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside the stack of {L}")
    key = _gemv_key("fused_gemv_paired_stacked", with_stats, _STACKED_DIMS,
                    x.shape[0], x.shape[0], L, G2, V2, O, group, spec.bits)
    if _on_cpu(x, tables):
        return _gemv_plain_tune(
            key, x, tables, G2, O,
            lambda: gemv_paired_stacked_plain(x, tables, layer, spec, scale,
                                              group, with_stats), autotune)
    return _launch_gemv("gemv_paired_stacked", x, tables, G2, O, 2 * group,
                        L * V2 * O, layer * V2 * O, spec, scale, with_stats,
                        key=key, autotune=autotune)


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
                          group: int, *,
                          autotune: Optional[bool] = None) -> torch.Tensor:
    """x ``[B, n]`` float32 (any ``n``), tables ``[G, V, O]``, plan_idx
    ``[G, group]`` int32 (entries in ``[-1, n)``; ``-1`` = unused slot) ->
    ``[B, O]`` in the table dtype: the fused GEMV of a generalized
    ``SegmentPlan``, which gathers ``x`` by the plan before it quantizes,
    packs and fetches.  The plan's bounds are checked once per tensor."""
    n = x.shape[1]
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
    key = _gemv_key("fused_gemv_plan", False, _GEMV_DIMS, x.shape[0], G, V,
                    O, group, spec.bits)
    if _on_cpu(x, tables, plan_idx):
        return _gemv_plain_tune(
            key, x, tables, G, O,
            lambda: gemv_plan_plain(x, tables, plan_idx, spec, scale, group),
            autotune)
    return _launch_gemv("gemv_plan", x, tables, G, O, group, V * O, 0, spec,
                        scale, False, plan_idx, key=key, autotune=autotune)


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


#: the tiled fused dwconv's constants (pcilt_dwconv1d.cu; the library's own
#: are checked against these at its first launch): lanes a channel tile (at
#: most), lanes a tile of 4-channel lanes (at most), the blocks the grid
#: aims for, the largest k it serves, the largest grid whose counters it
#: sums in one cluster
DW_TILED_THREADS, DW_WIDE_LANES, DW_TILED_TARGET_BLOCKS = 512, 128, 1056
DW_TILED_MAX_TAPS, DW_CLUSTER_BLOCKS = 8, 16


class DwTiledGrid(NamedTuple):
    """The tiled dwconv's grid over ``rows`` output rows (``B * To``) and
    ``C`` channels (``dw_tiled_grid`` of pcilt_dwconv1d.cu): block ``(x,
    y)`` owns channels ``[x * threads * nv, (x + 1) * threads * nv)``, a
    lane ``nv`` adjacent ones, and rows ``y, y + ry, ...``.  When ``tiles *
    ry <= DW_CLUSTER_BLOCKS`` the data blocks are one cluster and the
    launch holds a second, as large, that counts the saturation over the
    signal; else the data blocks count and sum through the ticket."""
    nv: int       # channels a lane (1 or 4)
    tiles: int    # channel tiles
    threads: int  # threads a block
    ry: int       # row blocks


def dwconv_tiled_grid(rows: int, C: int, wide: bool) -> DwTiledGrid:
    """The tiled grid: a channel a lane over tiles of up to
    ``DW_TILED_THREADS`` lanes where that puts every row in one cluster
    (the decode window: the most SMs for its two dependent trips to
    memory); else 4 channels a lane when ``wide`` (``C % 4 == 0`` and
    16-byte aligned operands) over tiles of up to ``DW_WIDE_LANES`` lanes,
    with as many row blocks as bring the grid to ``DW_TILED_TARGET_BLOCKS``
    (at most ``rows``)."""
    nv, lanes = 1, C
    tiles = -(-lanes // DW_TILED_THREADS)
    if tiles * rows > DW_CLUSTER_BLOCKS:
        nv = 4 if wide else 1
        lanes = -(-C // nv)
        tiles = -(-lanes // DW_WIDE_LANES)
    per_tile = -(-lanes // tiles)
    threads = -(-per_tile // 32) * 32
    ry = max(1, min(DW_TILED_TARGET_BLOCKS // tiles, rows))
    return DwTiledGrid(nv, tiles, threads, ry)


def dwconv_candidates(k: int) -> List[str]:
    """The fused dwconv designs that serve ``k`` taps, the heuristic's
    (:func:`dwconv_variant`) first."""
    return ["tiled", "direct"] if dwconv_variant(k) == "tiled" else ["direct"]


def dwconv_variant(k: int) -> str:
    """The fused dwconv's design for ``k`` taps: ``"tiled"`` while its taps
    fit the tiled design's registers (``k <= DW_TILED_MAX_TAPS``), else
    ``"direct"``."""
    return "tiled" if k <= DW_TILED_MAX_TAPS else "direct"


#: a design forced on the fused dwconv launches inside :func:`_dwconv_forced`
_DWCONV_FORCED: Optional[str] = None


@contextlib.contextmanager
def _dwconv_forced(variant: str):
    """Every fused dwconv launched on a CUDA tensor inside the block runs
    ``variant`` (tests and ``chip_smoke.py``); CPU tensors still run the
    plain version."""
    global _DWCONV_FORCED
    if variant not in DWCONV_VARIANT_LAUNCHES:
        raise ValueError(f"unknown fused dwconv variant {variant!r}")
    before, _DWCONV_FORCED = _DWCONV_FORCED, variant
    try:
        yield
    finally:
        _DWCONV_FORCED = before


#: (device index, stream) -> the tiled dwconv's int32 scratch {count, max
#: |x| bits, ticket, unused}: zeroed once when made, and every launch that
#: takes the ticket leaves it zeroed (its last block resets it)
_DWCONV_SCRATCH: Dict[tuple, torch.Tensor] = {}
_DW_TILED_CHECKED = set()


def _check_dwconv_grid(lib, rows: int, C: int, wide: bool) -> None:
    """The library's tiled grid of this shape must be this module's mirror
    of it (each shape checked once)."""
    key = (rows, C, wide)
    if key in _DW_TILED_CHECKED:
        return
    got = (ctypes.c_int * 4)()
    lib.pcilt_dwconv1d_tiled_plan(rows, C, int(wide), got)
    mine = dwconv_tiled_grid(rows, C, wide)
    if tuple(got) != tuple(mine):
        raise RuntimeError(f"pcilt_dwconv1d.cu tiles {rows} rows of C {C} "
                           f"as {tuple(got)}, kernels.ops as {tuple(mine)}")
    _DW_TILED_CHECKED.add(key)


def _dwconv_scratch(lib, dev: torch.device) -> torch.Tensor:
    """The scratch of ``dev``'s current stream (made on its first use, when
    the library's tiled constants are also checked against this module's)."""
    if "config" not in _DW_TILED_CHECKED:
        cfg = (ctypes.c_int * 5)()
        lib.pcilt_dwconv1d_tiled_config(cfg)
        mine = (DW_TILED_THREADS, DW_WIDE_LANES, DW_TILED_TARGET_BLOCKS,
                DW_TILED_MAX_TAPS, DW_CLUSTER_BLOCKS)
        if tuple(cfg) != mine:
            raise RuntimeError(f"pcilt_dwconv1d.cu's tiled constants "
                               f"{tuple(cfg)} differ from kernels.ops' {mine}")
        _DW_TILED_CHECKED.add("config")
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    scratch = _DWCONV_SCRATCH.get(key)
    if scratch is None:
        scratch = torch.zeros(4, dtype=torch.int32, device=dev)
        _DWCONV_SCRATCH[key] = scratch
    return scratch


def pcilt_fused_dwconv1d(x: torch.Tensor, tables: torch.Tensor,
                         spec: QuantSpec, scale, k: int,
                         padding: str = "CAUSAL", *,
                         autotune: Optional[bool] = None,
                         with_stats: bool = False):
    """x ``[B, T, C]`` float32, tables ``[C, V]`` (``V = 2**(bits*k)``)
    -> ``[B, To, C]`` in the table dtype (plus the saturation stats of the
    signal with ``with_stats``).  The only host-side work is the time pad
    of the signal (none for ``"VALID"``); a strided ``x`` (a channel block
    of a wider signal, as a mesh's channel shard gives it) is copied
    contiguous first, so the kernel always reads a packed ``[B, T, C]``."""
    return _fused_dwconv1d(x, tables, spec, scale, k, padding,
                           with_stats=with_stats, autotune=autotune)


def _fused_dwconv1d(x, tables, spec: QuantSpec, scale, k: int,
                    padding: str = "CAUSAL", *, with_stats: bool = False,
                    variant=None, autotune=None):
    """:func:`pcilt_fused_dwconv1d`, with ``variant`` forcing a design on a
    CUDA tensor (else the forced one, else the design cache's, else
    :func:`dwconv_variant`'s)."""
    B, T, C = x.shape
    C2, V = tables.shape
    if C != C2:
        raise ValueError(f"x channel dim {C} != tables channel dim {C2} "
                         f"(x {tuple(x.shape)}, tables {tuple(tables.shape)})")
    if V != 1 << (spec.bits * k):
        raise ValueError(f"tables value axis {V} != 2**(bits*k) = "
                         f"{1 << (spec.bits * k)}")
    lo, hi = _dwconv_pads(k, padding)
    # a channel block of a wider signal (a mesh shard's) is strided: the
    # pad copies it contiguous, and a VALID signal is copied so here
    xp = F.pad(x, (0, 0, lo, hi)) if lo or hi else x.contiguous()
    Tp = xp.shape[1]
    if Tp < k or B < 1:
        raise ValueError(f"signal of {T} steps is too short for {k} taps "
                         f"with padding {padding!r}")
    key = ("fused_dwconv1d_sat" if with_stats else "fused_dwconv1d",
           ("B", "T", "C", "V", "k", "bits"), (B, Tp - k + 1, C, V, k,
                                               spec.bits))
    if _on_cpu(xp, tables):
        def plain():
            return dwconv1d_plain(xp, tables, spec, scale, k, with_stats)

        _tune_plain(key, xp.device, tables.dtype,
                    lambda: dwconv_candidates(k), plain, autotune)
        return plain()
    dt = _check_launch("pcilt_fused_dwconv1d", xp, tables)
    variant = variant or _DWCONV_FORCED or _choose(
        key, xp.device, tables.dtype,
        lambda: dwconv_candidates(k),
        lambda d: lambda: _fused_dwconv1d(x, tables, spec, scale, k, padding,
                                          with_stats=with_stats, variant=d),
        autotune)
    if variant not in DWCONV_VARIANT_LAUNCHES:
        raise ValueError(f"pcilt_fused_dwconv1d: unknown variant {variant!r}")
    if variant == "tiled" and dwconv_variant(k) != "tiled":
        raise ValueError(f"pcilt_fused_dwconv1d: {k} taps cannot be tiled "
                         f"(at most {DW_TILED_MAX_TAPS})")
    lib = build.library("dwconv1d")
    out = torch.empty((B, Tp - k + 1, C), dtype=tables.dtype, device=x.device)
    stats = scratch = None
    if variant == "tiled":
        es = tables.element_size()
        wide = C % 4 == 0 and xp.data_ptr() % 16 == 0 \
            and out.data_ptr() % (4 * es) == 0
        scratch = _dwconv_scratch(lib, x.device)
        _check_dwconv_grid(lib, B * (Tp - k + 1), C, wide)
        if with_stats:  # written whole by the kernel
            stats = torch.empty(2, dtype=torch.int32, device=x.device)
    elif with_stats:  # the kept design adds into it
        stats = torch.zeros(2, dtype=torch.int32, device=x.device)
    _launch("dwconv1d", getattr(lib, f"pcilt_dwconv1d_{dt}"), xp, _ptr(xp),
            _ptr(tables), _ptr(out), _ptr(stats), _ptr(scratch), B, Tp, C, V,
            k, spec.bits, spec.zero_point, _host_scale(scale),
            int(with_stats), 0 if variant == "tiled" else 1)
    DWCONV_VARIANT_LAUNCHES[variant] += 1
    return (out, *_stats_out(stats)) if with_stats else out


#: the staged host-packed dwconv's constants (``kDw*`` of
#: pcilt_dwconv1d.cu; the library's own are checked against these at its
#: first launch): channels a block, threads a block, row passes a load
#: batch, the blocks the tiling aims for
DW_CHANS, DW_THREADS, DW_UNROLL, DW_TARGET_BLOCKS = 32, 256, 2, 396


class DwconvTiling(NamedTuple):
    """The staged dwconv's grid over ``M`` rows and ``C`` channels
    (``dw_tiling`` of pcilt_dwconv1d.cu): block ``i`` owns channels
    ``[(i % tiles) * DW_CHANS, ...)`` and rows ``[M*k // groups, M*(k+1) //
    groups)`` of row group ``k = i // tiles``; ``smem`` bytes of shared
    memory hold its slice of the table."""
    tiles: int   # channel tiles
    groups: int  # row groups
    smem: int    # shared-memory bytes a block


def dwconv_host_tiling(M: int, C: int, V: int, itemsize: int) -> DwconvTiling:
    """The staged dwconv's tiling of ``M`` rows of ``C`` channels over a
    table of ``V`` ``itemsize``-byte cells a channel: as many row groups as
    bring the grid to ``DW_TARGET_BLOCKS`` (at most ``M``)."""
    tiles = -(-C // DW_CHANS)
    groups = max(1, min(DW_TARGET_BLOCKS // tiles, M))
    return DwconvTiling(tiles, groups, DW_CHANS * V * itemsize)


def dwconv_host_candidates(V: int, itemsize: int) -> List[str]:
    """The host-packed dwconv designs a ``V``-value table admits, the
    heuristic's (:func:`dwconv_host_variant`) first."""
    if dwconv_host_variant(V, itemsize) == "staged":
        return ["staged", "direct"]
    return ["direct"]


def dwconv_host_variant(V: int, itemsize: int) -> str:
    """``"staged"`` while a block's table slice of ``V`` ``itemsize``-byte
    cells a channel fits its shared memory, else ``"direct"``."""
    return "staged" if DW_CHANS * V * itemsize <= SMEM_LIMIT else "direct"


_DW_CHECKED = set()


def _check_dwconv_tiling(lib, M: int, C: int, V: int, itemsize: int,
                         tiling: DwconvTiling) -> None:
    """The library's staged constants, and its tiling of this shape, must
    be this module's mirror of them (each shape checked once)."""
    if not _DW_CHECKED:
        cfg = (ctypes.c_int * 4)()
        lib.pcilt_dwconv1d_staged_config(cfg)
        mine = (DW_CHANS, DW_THREADS, DW_UNROLL, DW_TARGET_BLOCKS)
        if tuple(cfg) != mine:
            raise RuntimeError(f"pcilt_dwconv1d.cu's staged constants "
                               f"{tuple(cfg)} differ from kernels.ops' {mine}")
        _DW_CHECKED.add("config")
    key = (M, C, V, itemsize)
    if key in _DW_CHECKED:
        return
    got = (ctypes.c_int * 3)()
    lib.pcilt_dwconv1d_staged_plan(M, C, V, itemsize, got)
    if tuple(got) != tuple(tiling):
        raise RuntimeError(f"pcilt_dwconv1d.cu tiles M {M}, C {C}, V {V} as "
                           f"{tuple(got)}, kernels.ops as {tuple(tiling)}")
    _DW_CHECKED.add(key)


def pcilt_dwconv1d(offsets: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """offsets ``[B, T, C]`` int32 (packed by the caller), tables ``[C, V]``
    -> ``[B, T, C]`` in the table dtype: one fetch per output."""
    return _dwconv1d_host(offsets, tables)


def _dwconv1d_host(offsets, tables, variant=None, autotune=None):
    """:func:`pcilt_dwconv1d`, with ``variant`` forcing a design on a CUDA
    tensor (else the design cache's under a ``dwconv1d_host`` key, a key
    of the port's own: the reference's host-packed dwconv has no tiling to
    tune; else :func:`dwconv_host_variant`'s)."""
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
    es = tables.element_size()
    fits = dwconv_host_variant(V, es)
    if variant is None and offsets.numel():
        B, T = offsets.shape[:2]
        variant = _choose(
            ("dwconv1d_host", ("B", "T", "C", "V"), (B, T, C, V)),
            offsets.device, tables.dtype,
            lambda: dwconv_host_candidates(V, es),
            lambda d: lambda: _dwconv1d_host(offsets, tables, d), autotune)
    variant = variant or fits
    if variant not in DWCONV_HOST_VARIANT_LAUNCHES:
        raise ValueError(f"pcilt_dwconv1d: unknown variant {variant!r}")
    if variant == "staged" and fits != "staged":
        raise ValueError(f"pcilt_dwconv1d: a V = {V} table slice needs "
                         f"{DW_CHANS * V * es} B of shared memory a block (at"
                         f" most {SMEM_LIMIT}) and cannot be staged")
    out = torch.empty(offsets.shape, dtype=tables.dtype,
                      device=offsets.device)
    if out.numel():
        lib = build.library("dwconv1d")
        if variant == "staged":
            M = out.numel() // C
            _check_dwconv_tiling(lib, M, C, V, es,
                                 dwconv_host_tiling(M, C, V, es))
        _launch("dwconv1d_host", getattr(lib, f"pcilt_dwconv1d_host_{dt}"),
                offsets, _ptr(offsets), _ptr(tables), _ptr(out), out.numel(),
                C, V, 0 if variant == "staged" else 1)
        DWCONV_HOST_VARIANT_LAUNCHES[variant] += 1
    return out


# ----------------------------------------------------------------------------
# Shared-pool fused GEMV
# ----------------------------------------------------------------------------


#: the shared-pool split design's constants (pcilt_shared_gemv.cu; the
#: library's own are checked against these at its first launch): batch rows
#: a block (at most), warps a block (at most), bytes of columns a lane owns,
#: row loads a lane issues a batch, the blocks the split aims for, the
#: largest cluster, the fewest segments a slice
SHARED_ROWS, SHARED_WARPS, SHARED_LANE_BYTES, SHARED_LOADS = 4, 8, 16, 8
SHARED_TARGET_BLOCKS, SHARED_MAX_CLUSTER, SHARED_MIN_SEGS = 132, 16, 4
#: the occupancy the split kernel's ``__launch_bounds__`` asks for (blocks
#: an SM), an H100 SM's shared memory and the shared memory kept a block
SHARED_BLOCKS_PER_SM, SM_SMEM_BYTES, BLOCK_RESERVED_SMEM = 2, 228 * 1024, 1024


class SharedSplit(NamedTuple):
    """The shared-pool split design's launch over one call (``split_for``
    of pcilt_shared_gemv.cu): the grid is ``tiles * cluster`` by
    ``chunks`` blocks; block rank ``q`` of a cluster sums slice ``q`` of
    the segments (:func:`shared_gemv_slices`) for ``rows`` batch rows and
    ``tile`` columns."""
    rows: int     # batch rows a block (1, 2 or 4)
    warps: int    # warps a block
    cluster: int  # blocks a cluster
    tile: int     # columns a tile
    tiles: int    # column tiles
    chunks: int   # row chunks


@functools.lru_cache(maxsize=None)
def shared_gemv_variant(B: int, G: int, O: int, itemsize: int) -> SharedSplit:
    """The split of a shared-pool GEMV over ``B`` rows, ``G`` segments and
    ``O`` columns of ``itemsize``-byte cells: a lane owns
    ``SHARED_LANE_BYTES`` of columns, a block as many warps as cover O (at
    most ``SHARED_WARPS``) and ``B`` rows up to ``SHARED_ROWS`` (1, 2 or
    4), and the cluster doubles until the grid has
    ``SHARED_TARGET_BLOCKS`` blocks, but no slice falls under
    ``SHARED_MIN_SEGS`` segments; then it doubles on while
    ``SHARED_BLOCKS_PER_SM`` blocks' shared memory (each rank stages
    ``ceil(G / cluster)`` segments' rows) would not fit an SM."""
    rows = SHARED_ROWS if B >= 3 else B
    nv = SHARED_LANE_BYTES // itemsize
    warps = min(SHARED_WARPS, -(-O // (32 * nv)))
    tile = warps * 32 * nv
    tiles = -(-O // tile)
    chunks = -(-B // rows)
    cs = 1
    while cs < SHARED_MAX_CLUSTER and tiles * chunks * cs < \
            SHARED_TARGET_BLOCKS:
        cs *= 2
    while cs > 1 and cs * SHARED_MIN_SEGS > G:
        cs //= 2
    while cs < SHARED_MAX_CLUSTER and 2 * cs * SHARED_MIN_SEGS <= G and \
            SHARED_BLOCKS_PER_SM * (4 * rows * (tile + -(-G // cs))
                                    + BLOCK_RESERVED_SMEM) > SM_SMEM_BYTES:
        cs *= 2
    return SharedSplit(rows, warps, cs, tile, tiles, chunks)


def shared_gemv_smem_bytes(split: SharedSplit, G: int) -> int:
    """Dynamic shared memory of a split block: its float32 sums ``[rows,
    tile]``, then the int32 pool rows of its slice ``[ceil(G / cluster),
    rows]``."""
    return 4 * split.rows * (split.tile + -(-G // split.cluster))


def shared_gemv_slices(split: SharedSplit, G: int):
    """``[g0, g1)`` of each block rank of a cluster, in rank order: the
    ascending slices whose sums the split adds in this order."""
    cs = split.cluster
    return [(q * G // cs, (q + 1) * G // cs) for q in range(cs)]


def shared_gemv_candidates(B: int, G: int, O: int, itemsize: int) -> List[str]:
    """The shared-pool GEMV designs whose guards admit the shape:
    ``"split"`` (the heuristic) while a block's shared memory and the row
    chunks fit, ``"direct"`` while the ``B * G`` offsets fit one block."""
    split = shared_gemv_variant(B, G, O, itemsize)
    out = []
    if shared_gemv_smem_bytes(split, G) <= SMEM_LIMIT \
            and split.chunks <= 65535:
        out.append("split")
    if B * G * 4 <= SMEM_LIMIT:
        out.append("direct")
    return out or ["split"]


def shared_gemv_plain(x, pool, seg_idx, spec: QuantSpec, scale, group: int,
                      split_order: bool = False):
    """Plain version of the shared-pool kernel; a pointer outside
    ``[0, X)`` contributes nothing.  ``split_order`` sums in the split
    design's order (:func:`fetch_sum_sliced` over
    :func:`shared_gemv_slices`)."""
    s = torch.as_tensor(_host_scale(scale), dtype=x.dtype, device=x.device)
    off = pack_offsets(quantize(x, spec, s), spec.bits, group)
    X, V, O = pool.shape
    rows = pool_rows(off, seg_idx, X, V)
    if split_order:
        split = shared_gemv_variant(x.shape[0], rows.shape[1], O,
                                    pool.element_size())
        return fetch_sum_sliced(rows, pool.reshape(X * V, O),
                                shared_gemv_slices(split, rows.shape[1]))
    return fetch_sum(rows, pool.reshape(X * V, O))


_SHARED_CHECKED = set()


def _check_shared_split(lib, B: int, G: int, O: int, itemsize: int,
                        split: SharedSplit) -> None:
    """The library's split constants, and its split of this shape, must be
    this module's mirror of them (each shape checked once)."""
    if not _SHARED_CHECKED:
        cfg = (ctypes.c_int * 10)()
        lib.pcilt_shared_gemv_split_config(cfg)
        mine = (SHARED_ROWS, SHARED_WARPS, SHARED_LANE_BYTES, SHARED_LOADS,
                SHARED_TARGET_BLOCKS, SHARED_MAX_CLUSTER, SHARED_MIN_SEGS,
                SHARED_BLOCKS_PER_SM, SM_SMEM_BYTES, BLOCK_RESERVED_SMEM)
        if tuple(cfg) != mine:
            raise RuntimeError(f"pcilt_shared_gemv.cu's split constants "
                               f"{tuple(cfg)} differ from kernels.ops' {mine}")
        _SHARED_CHECKED.add("config")
    key = (B, G, O, itemsize)
    if key in _SHARED_CHECKED:
        return
    got = (ctypes.c_int * 7)()
    lib.pcilt_shared_gemv_split_plan(B, G, O, itemsize, got)
    mine = (*split, shared_gemv_smem_bytes(split, G))
    if tuple(got) != mine:
        raise RuntimeError(f"pcilt_shared_gemv.cu splits B {B}, G {G}, O {O}"
                           f" as {tuple(got)}, kernels.ops as {mine}")
    _SHARED_CHECKED.add(key)


def pcilt_shared_gemv(x: torch.Tensor, pool: torch.Tensor,
                      seg_idx: torch.Tensor, spec: QuantSpec, scale,
                      group: int, *,
                      autotune: Optional[bool] = None) -> torch.Tensor:
    """x ``[B, n]`` float32, pool ``[X, V, O]``, seg_idx ``[G]`` int32
    (``n == G * group``) -> ``[B, O]`` in the pool dtype."""
    return _shared_gemv(x, pool, seg_idx, spec, scale, group,
                        autotune=autotune)


def _shared_gemv(x, pool, seg_idx, spec: QuantSpec, scale, group: int,
                 variant=None, autotune=None):
    """:func:`pcilt_shared_gemv`, with ``variant`` forcing a design on a
    CUDA tensor (else the design cache's, else ``"split"``)."""
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
    es = pool.element_size()
    key = ("shared_gemv", ("B", "G", "V", "O", "X", "g", "bits"),
           (B, G, V, O, X, group, spec.bits))
    if _on_cpu(x, pool, seg_idx):
        def plain():
            return shared_gemv_plain(x, pool, seg_idx, spec, scale, group)

        _tune_plain(key, x.device, pool.dtype,
                    lambda: shared_gemv_candidates(B, G, O, es), plain,
                    autotune)
        return plain()
    dt = _check_launch("pcilt_shared_gemv", x, pool, seg_idx)
    variant = variant or _choose(
        key, x.device, pool.dtype,
        lambda: shared_gemv_candidates(B, G, O, es),
        lambda d: lambda: _shared_gemv(x, pool, seg_idx, spec, scale, group,
                                       variant=d), autotune)
    if variant not in SHARED_GEMV_VARIANT_LAUNCHES:
        raise ValueError(f"pcilt_shared_gemv: unknown variant {variant!r}")
    lib = build.library("shared_gemv")
    if variant == "split":
        split = shared_gemv_variant(B, G, O, pool.element_size())
        smem = shared_gemv_smem_bytes(split, G)
        if smem > SMEM_LIMIT or split.chunks > 65535:
            raise ValueError(f"pcilt_shared_gemv: B = {B}, G = {G} needs "
                             f"{smem} B of shared memory a block (at most "
                             f"{SMEM_LIMIT}) and {split.chunks} row chunks "
                             f"(at most 65535)")
        _check_shared_split(lib, B, G, O, pool.element_size(), split)
    elif B * G * 4 > SMEM_LIMIT:
        raise ValueError(f"pcilt_shared_gemv: B*G = {B * G} offsets exceed "
                         f"the shared memory of one block")
    out = torch.empty((B, O), dtype=pool.dtype, device=x.device)
    _launch("shared_gemv", getattr(lib, f"pcilt_shared_gemv_{dt}"), x,
            _ptr(x), _ptr(seg_idx), _ptr(pool), _ptr(out), B, G, X, V, O,
            group, spec.bits, spec.zero_point, _host_scale(scale),
            0 if variant == "split" else 1)
    SHARED_GEMV_VARIANT_LAUNCHES[variant] += 1
    return out


# ----------------------------------------------------------------------------
# Host-packed GEMV and conv2d
# ----------------------------------------------------------------------------


#: the staged host-packed GEMV's tiling (``namespace hstaged`` of
#: pcilt_gemv.cu; the library's own values are checked against these at its
#: first launch): rows and columns a block, slice slots, segments a row's
#: offsets are read in, offset slots, the largest V
HOST_ROW_TILE, HOST_COL_TILE, HOST_STAGES = 1024, 32, 4
HOST_CHUNK, HOST_OFF_RING, HOST_MAX_V = 8, 16, 256


def gemv_host_smem_bytes(itemsize: int) -> int:
    """Shared memory of a staged host-packed block: ``HOST_STAGES`` table
    slices (as :func:`staged_smem_bytes` lays them out), then
    ``HOST_OFF_RING`` slots of ``HOST_ROW_TILE`` offset bytes, of a
    ``HOST_MAX_V``-byte row mask, of a ``HOST_ROW_TILE``-bit bad-row mask
    and of a 4-byte segment flag, then one chunk of raw int32 offsets
    ``[HOST_ROW_TILE, HOST_CHUNK]``."""
    per_row = STAGED_ROW_PITCH // (HOST_COL_TILE * itemsize)
    blocks = -(-HOST_STAGES // per_row)
    return (blocks * HOST_MAX_V * STAGED_ROW_PITCH
            + HOST_OFF_RING * (HOST_ROW_TILE + HOST_MAX_V
                               + HOST_ROW_TILE // 8 + 4)
            + HOST_ROW_TILE * HOST_CHUNK * 4)


def gemv_host_variant(M: int, G: int, V: int, O: int, itemsize: int) -> str:
    """The host-packed GEMV's design over ``M`` rows, ``G`` segments, ``V``
    values and ``O`` columns of ``itemsize``-byte cells: ``"staged"`` while
    every offset fits a byte (``V <= HOST_MAX_V``), the ring fits a block's
    shared memory and ``M`` fills at least one row tile; else ``"direct"``
    (the M = 4 GEMVs of plans and learnable tables).  G and O do not
    change the choice."""
    if V <= HOST_MAX_V and gemv_host_smem_bytes(itemsize) <= SMEM_LIMIT \
            and M >= HOST_ROW_TILE:
        return "staged"
    return "direct"


def gemv_host_candidates(M: int, G: int, V: int, O: int,
                         itemsize: int) -> List[str]:
    """The host-packed GEMV designs whose guards admit the shape, the
    heuristic's (:func:`gemv_host_variant`) first: ``"staged"`` while
    every offset fits a byte and the ring fits a block (any ``M``),
    ``"direct"`` always."""
    first = gemv_host_variant(M, G, V, O, itemsize)
    if V <= HOST_MAX_V and gemv_host_smem_bytes(itemsize) <= SMEM_LIMIT:
        return [first, "direct" if first == "staged" else "staged"]
    return ["direct"]


def gemv_host_tiles(M: int, O: int):
    """``(row tiles, column tiles)`` of the staged grid over ``M`` rows and
    ``O`` columns; the grid has their product of blocks."""
    return -(-M // HOST_ROW_TILE), -(-O // HOST_COL_TILE)


def gemv_host_block_tile(i: int, M: int, O: int):
    """Block ``i``'s ``((m0, m1), (o0, o1))`` in the staged grid, clipped to
    ``M`` and ``O``: row tile ``i % n_rtiles`` of column tile ``i //
    n_rtiles`` (the blocks resident together share a column tile)."""
    n_r, _ = gemv_host_tiles(M, O)
    m0, o0 = (i % n_r) * HOST_ROW_TILE, (i // n_r) * HOST_COL_TILE
    return ((m0, min(M, m0 + HOST_ROW_TILE)),
            (o0, min(O, o0 + HOST_COL_TILE)))


def gemv_host_plain(offsets, tables):
    """Plain version of kernels 6 and 7: offsets ``[..., G]``, tables ``[G,
    V, O]`` -> ``[..., O]``, ``kernels.ref.pcilt_gemv_ref`` over the
    flattened rows."""
    G, _, O = tables.shape
    out = pcilt_gemv_ref(offsets.reshape(-1, G), tables)
    return out.reshape(*offsets.shape[:-1], O)


_HOST_CHECKED = []


def _check_host_config(lib) -> None:
    """The library's staged host-packed tiling must be this module's mirror
    of it."""
    if _HOST_CHECKED:
        return
    cfg = (ctypes.c_int * 6)()
    lib.pcilt_gemv_host_staged_config(cfg)
    mine = (HOST_ROW_TILE, HOST_COL_TILE, HOST_STAGES, HOST_CHUNK,
            HOST_OFF_RING, HOST_MAX_V)
    if tuple(cfg) != mine:
        raise RuntimeError(f"pcilt_gemv.cu's staged tiling {tuple(cfg)} "
                           f"differs from kernels.ops' {mine}")
    _HOST_CHECKED.append(True)


def _launch_gemv_host(name: str, offsets: torch.Tensor,
                      tables: torch.Tensor, variant=None,
                      autotune=None) -> torch.Tensor:
    """Kernel 6 (or 7, by ``name``) over the ``[..., G]`` offsets flattened
    to rows; ``variant`` forces a design on a CUDA tensor (else the design
    cache's, else :func:`gemv_host_variant`'s)."""
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
    es = tables.element_size()
    if name == "gemv_host":
        key = (name, ("B", "G", "V", "O"), (M, G, V, O))
    else:
        key = (name, ("B", "Ho", "Wo", "G", "V", "O"),
               (*offsets.shape[:3], G, V, O))
    if _on_cpu(offsets, tables):
        def plain():
            return gemv_host_plain(offsets, tables)

        _tune_plain(key, offsets.device, tables.dtype,
                    lambda: gemv_host_candidates(M, G, V, O, es), plain,
                    autotune)
        return plain()
    dt = _check_tables(name, tables, offsets)
    variant = variant or _choose(
        key, offsets.device, tables.dtype,
        lambda: gemv_host_candidates(M, G, V, O, es),
        lambda d: lambda: _launch_gemv_host(name, offsets, tables, d),
        autotune)
    if variant not in GEMV_HOST_VARIANT_LAUNCHES:
        raise ValueError(f"{name}: unknown variant {variant!r}")
    lib = build.library("gemv_host")
    if variant == "staged":
        if V > HOST_MAX_V or gemv_host_smem_bytes(es) > SMEM_LIMIT:
            raise ValueError(f"{name}: a V = {V} slice cannot be staged (V <="
                             f" {HOST_MAX_V} and {gemv_host_smem_bytes(es)} "
                             f"B of shared memory <= {SMEM_LIMIT} B needed)")
        _check_host_config(lib)
    out = torch.empty((M, O), dtype=tables.dtype, device=tables.device)
    _launch(name, getattr(lib, f"pcilt_gemv_host_{dt}"), tables,
            _ptr(offsets), _ptr(tables), _ptr(out), M, G, V, O,
            0 if variant == "staged" else 1)
    GEMV_HOST_VARIANT_LAUNCHES[variant] += 1
    return out.reshape(*offsets.shape[:-1], O)


def pcilt_gemv(offsets: torch.Tensor, tables: torch.Tensor, *,
               autotune: Optional[bool] = None) -> torch.Tensor:
    """offsets ``[M, G]`` int32 (packed by the caller), tables ``[G, V, O]``
    -> ``[M, O]`` in the table dtype: ``sum_g T[g, off[m, g]]``."""
    return _gemv_host(offsets, tables, autotune=autotune)


def _gemv_host(offsets, tables, variant=None, autotune=None):
    """:func:`pcilt_gemv`, with ``variant`` forcing a design on a CUDA
    tensor."""
    if offsets.dim() != 2:
        raise ValueError(f"offsets must be [M, G], got {tuple(offsets.shape)}")
    return _launch_gemv_host("gemv_host", offsets, tables, variant, autotune)


def pcilt_conv2d(offsets: torch.Tensor, tables: torch.Tensor, *,
                 autotune: Optional[bool] = None) -> torch.Tensor:
    """offsets ``[B, Ho, Wo, G]`` int32, tables ``[G, V, O]`` ->
    ``[B, Ho, Wo, O]``: the host-packed conv fetch, the GEMV kernel over the
    flattened pixels."""
    return _conv2d_host(offsets, tables, autotune=autotune)


def _conv2d_host(offsets, tables, variant=None, autotune=None):
    """:func:`pcilt_conv2d`, with ``variant`` forcing a design on a CUDA
    tensor."""
    if offsets.dim() != 4:
        raise ValueError(f"offsets must be [B, Ho, Wo, G], got "
                         f"{tuple(offsets.shape)}")
    return _launch_gemv_host("conv2d_host", offsets, tables, variant,
                             autotune)


# ----------------------------------------------------------------------------
# Fused and shared-pool conv2d
# ----------------------------------------------------------------------------


def _conv_plain_offsets(xp, spec: QuantSpec, scale, group: int, kh: int,
                        kw: int, stride: int, G: int, seg_offset: int = 0,
                        n_total: Optional[int] = None) -> torch.Tensor:
    """The conv kernels' activation side on the host, over the padded image
    and at the kernel's float32 scale -> ``[B*Ho*Wo, G]`` int32: segments
    ``seg_offset .. seg_offset + G - 1`` of the patch padded with code 0 to
    ``n_total`` (``G * group`` by default)."""
    s = torch.as_tensor(_host_scale(scale), dtype=xp.dtype, device=xp.device)
    codes = quantize(im2col(xp, kh, kw, stride, "VALID"), spec, s)
    n_total = G * group if n_total is None else n_total
    codes = F.pad(codes, (0, n_total - codes.shape[-1]))
    off = pack_offsets(codes[..., seg_offset * group:(seg_offset + G) * group],
                       spec.bits, group)
    return off.reshape(-1, G)


def fused_conv2d_plain(xp, tables, spec: QuantSpec, scale, group: int,
                       kh: int, kw: int, stride: int, seg_offset: int = 0,
                       n_total: Optional[int] = None):
    """Plain version of the fused conv kernel over the padded image (its
    tables segments ``seg_offset ..`` of a patch padded to ``n_total``)."""
    return pcilt_gemv_ref(_conv_plain_offsets(
        xp, spec, scale, group, kh, kw, stride, tables.shape[0], seg_offset,
        n_total), tables)


def shared_conv2d_plain(xp, pool, seg_idx, spec: QuantSpec, scale,
                        group: int, kh: int, kw: int, stride: int,
                        seg_offset: int = 0, n_total: Optional[int] = None):
    """Plain version of the shared-pool conv kernel over the padded image;
    a pointer outside ``[0, X)`` adds nothing."""
    X, V, O = pool.shape
    off = _conv_plain_offsets(xp, spec, scale, group, kh, kw, stride,
                              int(seg_idx.shape[0]), seg_offset, n_total)
    return fetch_sum(pool_rows(off, seg_idx, X, V), pool.reshape(X * V, O))


def _conv_geometry(name, x, G, V, spec, group, kh, kw, stride, padding,
                   seg_offset=0, n_total=None):
    """Pad the float image (the only host-side work) and check the shapes
    (a shard's segments ``seg_offset .. seg_offset + G - 1`` inside the
    padded patch of ``n_total`` slots) -> ``(xp, Ho, Wo, n_total)``."""
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
    n_total = G * group if n_total is None else int(n_total)
    seg_offset = int(seg_offset)
    if n_total < kh * kw * C:
        raise ValueError(f"{name}: the padded patch n_total = {n_total} "
                         f"(G*group = {G}*{group} unsharded) does not cover "
                         f"the patch length kh*kw*C = {kh * kw * C}")
    if seg_offset < 0 or (seg_offset + G) * group > n_total:
        raise ValueError(f"{name}: segments {seg_offset} .. "
                         f"{seg_offset + G - 1} of {group} slots lie outside "
                         f"the padded patch of n_total = {n_total}")
    if V != 1 << (spec.bits * group):
        raise ValueError(f"{name}: value axis {V} != 2**(bits*group) = "
                         f"{1 << (spec.bits * group)}")
    return xp, Ho, Wo, n_total


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


def conv_candidates(V: int, itemsize: int) -> List[str]:
    """The conv designs a ``V``-value table admits, the heuristic's
    (:func:`conv_variant`) first."""
    return ["staged", "direct"] if conv_variant(V, itemsize) == "staged" \
        else ["direct"]


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


def conv_code_channels(C: int, kh: int, kw: int, group: int,
                       seg_offset: int, G: int):
    """``(c0, Cs)``: the channels ``c0 .. c0 + Cs - 1`` that a shard's live
    patch positions ``seg_offset * group .. min(kh*kw*C, (seg_offset + G) *
    group) - 1`` touch (positions in ``[kh, kw, C]`` order); all ``C`` once
    they reach past one tap, ``(0, 1)`` when none is live."""
    p0 = seg_offset * group
    p1 = min(kh * kw * C, (seg_offset + G) * group)
    if p1 <= p0:
        return 0, 1
    if p0 // C != (p1 - 1) // C:
        return 0, C
    return p0 % C, (p1 - 1) % C - p0 % C + 1


def conv_codes_plain(xp: torch.Tensor, spec: QuantSpec, scale, c0: int = 0,
                     Cs: Optional[int] = None) -> torch.Tensor:
    """Plain version of the staged design's pre-pass: the padded image
    ``[B, Hp, Wp, C]`` float32 -> the codes ``[B, Cs, Hp, Wp]`` uint8 of its
    channels ``c0 .. c0 + Cs - 1`` (all by default), at the kernel's float32
    scale."""
    s = torch.as_tensor(_host_scale(scale), dtype=xp.dtype, device=xp.device)
    Cs = xp.shape[-1] - c0 if Cs is None else Cs
    return quantize(xp[..., c0:c0 + Cs], spec, s).permute(0, 3, 1, 2) \
        .contiguous()


def _conv_codes(xp: torch.Tensor, spec: QuantSpec, scale, c0: int = 0,
                Cs: Optional[int] = None) -> torch.Tensor:
    """The pre-pass: its kernel on a CUDA tensor, its plain version on the
    CPU (not counted: it is half of one conv launch)."""
    if _on_cpu(xp):
        return conv_codes_plain(xp, spec, scale, c0, Cs)
    if spec.bits > 8:
        raise ValueError(f"codes of {spec.bits} bits do not fit a byte")
    if xp.dtype != torch.float32 or not xp.is_contiguous():
        raise ValueError(f"conv2d codes: the padded image must be a "
                         f"contiguous float32 tensor, got {xp.dtype} with "
                         f"strides {xp.stride()}")
    B, Hp, Wp, C = xp.shape
    Cs = C - c0 if Cs is None else Cs
    codes = torch.empty((B, Cs, Hp, Wp), dtype=torch.uint8, device=xp.device)
    fn = build.library("conv2d").pcilt_conv2d_codes_f32
    _call("conv2d codes", fn, xp, _ptr(xp), _ptr(codes), B, Hp, Wp, C, c0,
          Cs, spec.bits, spec.zero_point, _host_scale(scale))
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


def _conv_key(name, xp, G, V, O, X, group, kh, kw, stride, bits):
    """``(kernel, names, values)`` of a conv launch (the reference's key;
    the shared pool's adds ``X``).  A shard's launch keys on its local
    ``G`` and local pool ``X``; its ``seg_offset`` is not in the key, so the
    shards of one layer share one key."""
    B, Hp, Wp, C = xp.shape
    names = ("B", "Ho", "W", "C", "k", "s", "G", "V", "O", "g", "bits")
    values = (B, (Hp - kh) // stride + 1, Wp, C, kh * kw, stride, G, V, O,
              group, bits)
    if name == "shared_conv2d":
        names, values = names + ("X",), values + (X,)
    return name, names, values


def _launch_conv(name, xp, tab, seg_idx, X, spec, scale, group, kh, kw,
                 stride, Ho, Wo, variant=None, autotune=None, seg_offset=0,
                 n_total=None):
    B, Hp, Wp, C = xp.shape
    G = int(seg_idx.shape[0]) if seg_idx is not None else tab.shape[0]
    _, V, O = tab.shape
    others = () if seg_idx is None else (seg_idx,)
    dt = _check_launch(name, xp, tab, *others)
    es = tab.element_size()
    fits = conv_variant(V, es)
    if variant is None:
        key = _conv_key(name, xp, G, V, O, X, group, kh, kw, stride,
                        spec.bits)
        variant = _choose(
            key, xp.device, tab.dtype,
            lambda: conv_candidates(V, es),
            lambda d: lambda: _launch_conv(name, xp, tab, seg_idx, X, spec,
                                           scale, group, kh, kw, stride, Ho,
                                           Wo, d, seg_offset=seg_offset,
                                           n_total=n_total), autotune)
    if variant not in CONV_VARIANT_LAUNCHES:
        raise ValueError(f"{name}: unknown conv variant {variant!r}")
    if variant == "staged" and fits != "staged":
        raise ValueError(f"{name}: a V = {V} slice cannot be staged "
                         f"(V <= {STAGED_MAX_V} and "
                         f"{staged_smem_bytes(tab.element_size())} B of "
                         f"shared memory <= {SMEM_LIMIT} B needed)")
    n_total = G * group if n_total is None else n_total
    out = torch.empty((B, Ho, Wo, O), dtype=tab.dtype, device=xp.device)
    lib = build.library("conv2d")
    if variant == "staged":
        _check_staged_config()
        c0, Cs = conv_code_channels(C, kh, kw, group, seg_offset, G)
        codes = _conv_codes(xp, spec, scale, c0, Cs)
        fn = getattr(lib, f"pcilt_{name}_staged_{dt}")
        _launch(name, fn, xp, _ptr(codes), _ptr(tab), _ptr(seg_idx),
                _ptr(out), B, C, Hp, Wp, Ho, Wo, kh, kw, stride, G, X, V, O,
                group, spec.bits, seg_offset, n_total, c0, Cs)
    else:
        fn = getattr(lib, f"pcilt_{name}_{dt}")
        _launch(name, fn, xp, _ptr(xp), _ptr(tab), _ptr(seg_idx), _ptr(out),
                B, Hp, Wp, C, Ho, Wo, kh, kw, stride, G, X, V, O, group,
                spec.bits, spec.zero_point, _host_scale(scale), seg_offset,
                n_total)
    CONV_VARIANT_LAUNCHES[variant] += 1
    return out


def pcilt_fused_conv2d(x: torch.Tensor, tables: torch.Tensor,
                       spec: QuantSpec, scale, group: int, kh: int, kw: int,
                       stride: int = 1, padding: str = "SAME", *,
                       autotune: Optional[bool] = None, seg_offset: int = 0,
                       n_total: Optional[int] = None) -> torch.Tensor:
    """x ``[B, H, W, C]`` float32 NHWC, tables ``[G, V, O]`` ->
    ``[B, Ho, Wo, O]`` in the table dtype.  The only host-side work is the
    spatial zero pad of the float image (SAME by :func:`conv_same_pads`);
    quantize, im2col and pack run on the card, so neither the float patches
    nor the offsets reach device memory.  ``G * group >= kh*kw*C``: the
    alignment slots take code 0 against zero-weight table rows.

    A segment shard of a mesh passes ``seg_offset`` (its first segment in
    the global segment space) and ``n_total`` (the global padded patch
    length, ``>= kh*kw*C``): the kernel fetches patch positions
    ``(seg_offset + g) * group + j`` for its ``G`` local segments.  The
    design cache keys on the local ``G``."""
    return _fused_conv2d(x, tables, spec, scale, group, kh, kw, stride,
                         padding, autotune=autotune, seg_offset=seg_offset,
                         n_total=n_total)


def _fused_conv2d(x, tables, spec: QuantSpec, scale, group: int, kh: int,
                  kw: int, stride: int = 1, padding: str = "SAME",
                  variant=None, autotune=None, seg_offset=0, n_total=None):
    """:func:`pcilt_fused_conv2d`, with ``variant`` forcing a design on a
    CUDA tensor."""
    G, V, O = tables.shape
    xp, Ho, Wo, n_total = _conv_geometry(
        "pcilt_fused_conv2d", x, G, V, spec, group, kh, kw, stride, padding,
        seg_offset, n_total)
    if _on_cpu(xp, tables):
        def plain():
            return fused_conv2d_plain(
                xp, tables, spec, scale, group, kh, kw, stride, seg_offset,
                n_total).reshape(xp.shape[0], Ho, Wo, O)

        key = _conv_key("fused_conv2d", xp, G, V, O, 0, group, kh, kw,
                        stride, spec.bits)
        _tune_plain(key, xp.device, tables.dtype,
                    lambda: conv_candidates(V, tables.element_size()), plain,
                    autotune)
        return plain()
    return _launch_conv("fused_conv2d", xp, tables, None, 0, spec, scale,
                        group, kh, kw, stride, Ho, Wo, variant, autotune,
                        int(seg_offset), n_total)


def pcilt_shared_conv2d(x: torch.Tensor, pool: torch.Tensor,
                        seg_idx: torch.Tensor, spec: QuantSpec, scale,
                        group: int, kh: int, kw: int, stride: int = 1,
                        padding: str = "SAME", *,
                        autotune: Optional[bool] = None, seg_offset: int = 0,
                        n_total: Optional[int] = None) -> torch.Tensor:
    """x ``[B, H, W, C]`` float32 NHWC, pool ``[X, V, O]``, seg_idx ``[G]``
    int32 -> ``[B, Ho, Wo, O]`` in the pool dtype: the fused conv with
    ``T[g]`` replaced by ``pool[seg_idx[g]]``; a pointer outside ``[0, X)``
    adds nothing.  The pool is read in place (no transpose).
    ``seg_offset`` / ``n_total`` place a shard's local pool and pointers in
    the global patch, as :func:`pcilt_fused_conv2d`'s."""
    return _shared_conv2d(x, pool, seg_idx, spec, scale, group, kh, kw,
                          stride, padding, autotune=autotune,
                          seg_offset=seg_offset, n_total=n_total)


def _shared_conv2d(x, pool, seg_idx, spec: QuantSpec, scale, group: int,
                   kh: int, kw: int, stride: int = 1, padding: str = "SAME",
                   variant=None, autotune=None, seg_offset=0, n_total=None):
    """:func:`pcilt_shared_conv2d`, with ``variant`` forcing a design on a
    CUDA tensor."""
    X, V, O = pool.shape
    if seg_idx.dim() != 1 or seg_idx.dtype != torch.int32:
        raise TypeError(f"seg_idx must be a 1-d int32 tensor, got "
                        f"{seg_idx.dtype} {tuple(seg_idx.shape)}")
    G = int(seg_idx.shape[0])
    xp, Ho, Wo, n_total = _conv_geometry(
        "pcilt_shared_conv2d", x, G, V, spec, group, kh, kw, stride, padding,
        seg_offset, n_total)
    if _on_cpu(xp, pool, seg_idx):
        def plain():
            return shared_conv2d_plain(
                xp, pool, seg_idx, spec, scale, group, kh, kw, stride,
                seg_offset, n_total).reshape(xp.shape[0], Ho, Wo, O)

        key = _conv_key("shared_conv2d", xp, G, V, O, X, group, kh, kw,
                        stride, spec.bits)
        _tune_plain(key, xp.device, pool.dtype,
                    lambda: conv_candidates(V, pool.element_size()), plain,
                    autotune)
        return plain()
    return _launch_conv("shared_conv2d", xp, pool, seg_idx, X, spec, scale,
                        group, kh, kw, stride, Ho, Wo, variant, autotune,
                        int(seg_offset), n_total)


# ----------------------------------------------------------------------------
# CRC-32 of table bytes (the integrity record and checks)
# ----------------------------------------------------------------------------

#: nodes one combine block of the CRC reduces (``kCombine`` of
#: pcilt_crc32.cu)
CRC_COMBINE = 1024
_CRC_CHECKED: list = []
#: device -> the CRC's operator table [CRC_LEVELS, 32] on it
_CRC_OPS: Dict[torch.device, torch.Tensor] = {}
#: (device, stream and range rows) -> those rows on the device, the most
#: recently used CRC_TABLES_KEPT of them
_CRC_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
CRC_TABLES_KEPT = 256
#: device launches the CRC library reports making for the wrapper's calls
#: (a chunk pass and its combine passes a call; ``LAUNCHES["crc32"]``
#: counts the calls)
CRC_DEVICE_LAUNCHES: Dict[str, int] = {"passes": 0}


def _crc_ops(lib, dev: torch.device) -> torch.Tensor:
    """The operator table on ``dev`` (uploaded once), after checking the
    library's constants against this module's mirror of them."""
    if not _CRC_CHECKED:
        cfg = (ctypes.c_int * 4)()
        lib.pcilt_crc32_config(cfg)
        mine = (CRC_LANE_BYTES, CRC_CHUNK_BYTES, CRC_LEVELS, CRC_COMBINE)
        if tuple(cfg) != mine:
            raise RuntimeError(f"pcilt_crc32.cu's constants {tuple(cfg)} "
                               f"differ from kernels.ops' {mine}")
        _CRC_CHECKED.append(True)
    table = _CRC_OPS.get(dev)
    if table is None:
        table = torch.from_numpy(crc_operators().view(np.int32)).to(dev)
        _CRC_OPS[dev] = table
    return table


def _crc_stream(stream):
    """``(tensor, starts, length)`` of one stream of :func:`pcilt_crc32`,
    checked: a contiguous tensor, byte starts (int64) and a length whose
    ranges lie inside the tensor's bytes."""
    t, starts, length = (stream, None, None) if torch.is_tensor(stream) \
        else stream
    if not t.is_contiguous():
        raise ValueError(f"pcilt_crc32: tensors must be contiguous (got "
                         f"strides {t.stride()} for shape {tuple(t.shape)})")
    nbytes = t.numel() * t.element_size()
    if starts is None:
        starts, length = (0,), nbytes
    starts = np.asarray(starts, np.int64).reshape(-1)
    length = int(length)
    if length < 0 or (starts.size and length and (
            starts.min() < 0 or starts.max() + length > nbytes)):
        raise ValueError(f"pcilt_crc32: ranges of {length} bytes from "
                         f"{starts.min() if starts.size else 0} to "
                         f"{starts.max() if starts.size else 0} exceed the "
                         f"tensor's {nbytes} bytes")
    return t, starts, length


def _crc_table(dev: torch.device, rows: np.ndarray) -> torch.Tensor:
    """The kernel's stream and range rows on ``dev``: uploaded once, then
    reused while the same rows recur (a table's ranges are fixed while it
    is resident, so a monitor's checks copy nothing to the card)."""
    key = (dev, rows.tobytes())
    table = _CRC_TABLES.get(key)
    if table is None:
        table = torch.from_numpy(rows).to(dev)
        _CRC_TABLES[key] = table
        if len(_CRC_TABLES) > CRC_TABLES_KEPT:
            _CRC_TABLES.popitem(last=False)
    else:
        _CRC_TABLES.move_to_end(key)
    return table


def pcilt_crc32(streams) -> List[int]:
    """``zlib.crc32`` of each stream.  A stream is a contiguous tensor (its
    C-order bytes; a bfloat16 table's are its 16-bit words) or ``(t,
    starts, length)``: the ``length`` bytes of ``t``'s bytes at each offset
    in ``starts``, back to back (a layer of a layer-major stack is one
    start; a layer of a segment-major ``[G2, L, V2, O]`` stack is ``G2``
    starts ``L`` segments apart).  CUDA tensors (on one device): one launch
    of the CRC kernel for every stream, counted once, and one read back of
    their 32-bit words; CPU tensors run :func:`crc32_plain`."""
    specs = [_crc_stream(s) for s in streams]
    if not specs:
        return []
    if _on_cpu(*(t for t, _, _ in specs)):
        out = []
        for t, starts, length in specs:
            flat = t.detach().reshape(-1).view(torch.uint8)
            out.append(crc32_plain([flat[a:a + length] for a in starts]))
        return out
    totals = [st.size * n for _, st, n in specs]
    live = [i for i, n in enumerate(totals) if n]
    res = [0] * len(specs)  # zlib.crc32(b"")
    if not live:
        return res
    dev = specs[live[0]][0].device
    nch = np.array([-(-totals[i] // CRC_CHUNK_BYTES) for i in live], np.int64)
    nr = np.array([specs[i][1].size for i in live], np.int64)
    srows = np.stack([np.cumsum(nr) - nr, nr,
                      np.array([totals[i] for i in live], np.int64),
                      np.cumsum(nch) - nch, nch], 1)
    rrows = np.concatenate([
        np.stack([t.data_ptr() + st, np.full(st.size, n, np.int64),
                  n * np.arange(st.size, dtype=np.int64)], 1)
        for t, st, n in (specs[i] for i in live)])
    table = _crc_table(dev, np.concatenate([srows.reshape(-1),
                                            rrows.reshape(-1)]))
    n_streams, nchunks = len(live), int(nch.sum())
    levels = int(nch.max() - 1).bit_length()
    half = n_streams * ((1 << levels) // CRC_COMBINE + 1)
    ws = torch.empty(nchunks + 2 * half + n_streams, dtype=torch.int32,
                     device=dev)
    out = ws[nchunks + 2 * half:]
    lib = build.library("crc32")
    made = ctypes.c_int(0)
    _launch("crc32", lib.pcilt_crc32, table, _ptr(table), n_streams,
            nchunks, levels, _ptr(ws), _ptr(ws[nchunks:]),
            _ptr(_crc_ops(lib, dev)), _ptr(out),
            ctypes.c_void_p(ctypes.addressof(made)))
    CRC_DEVICE_LAUNCHES["passes"] += made.value
    pure = out.cpu().numpy().view(np.uint32)
    for j, i in enumerate(live):
        res[i] = crc32_finish(int(pure[j]), totals[i])
    return res
