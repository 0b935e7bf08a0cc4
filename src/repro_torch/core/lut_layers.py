"""PCILT inference layers (port of a subset of ``repro.core.lut_layers``).

Paths of :func:`pcilt_linear`:

* ``"gather"`` — the literal algorithm: quantize, pack offsets, gather the
  table rows and sum them (the reference semantics);
* ``"onehot"`` — the same fetch as ``onehot(off) @ T`` (the reference's
  matmul form of the lookup);
* ``"kernel"`` — host-packed offsets through the host-packed GEMV kernel
  (``kernels.ops.pcilt_gemv``), the baseline the fused paths replace;
* ``"fused"`` — quantize, pack and fetch in one kernel: over ``[G, V, O]``
  tables (``kernels.ops.pcilt_fused_gemv``) or, with ``stacked=layer``,
  over ``[L, G, V, O]`` (``kernels.ops.pcilt_fused_gemv_stacked``); the
  layer is selected by pointer arithmetic, never copied;
* ``paired=True`` — TL1-style paired tables, two adjacent segments per
  fetch: ``"fused"`` runs ``kernels.ops.pcilt_fused_gemv_paired`` (or, with
  ``stacked=``, ``pcilt_fused_gemv_paired_stacked`` over the segment-major
  ``[G2, L, V2, O]`` stack), the host-packed paths the paired table as a
  grouped table of width ``2 * group``;
* ``"shared"`` — the shared-pool fused GEMV over a
  :class:`~repro_torch.core.pcilt.SharedGroupedTables`
  (``kernels.ops.pcilt_shared_gemv``); a scalar
  :class:`~repro_torch.core.pcilt.SharedTables` runs there (and on
  ``"gather"``) as its 1-wide segment pool;
* ``plan=`` — a generalized ``SegmentPlan``: the host-packed paths pack by
  ``plan.pack``, ``"fused"`` runs ``kernels.ops.pcilt_fused_gemv_plan``,
  which gathers ``x`` by the plan in the kernel.

:func:`pcilt_conv2d` reduces the convolution to the linear case by
``im2col`` (patches flattened ``[kh, kw, C]``) on the host-packed paths;
``"fused"`` and ``"shared"`` run the conv kernels, which quantize, im2col
and pack inside the kernel from the spatially padded float image.

Mesh execution (tensor-parallel tables): with ``mesh=`` (a
``launch.mesh.Mesh``; ``mesh_axis`` default ``"model"``) the segment axis
is cut into ``D`` contiguous blocks over the mesh axis.  Each device runs
the unsharded route on its ``[G/D, V, O]`` block (a ``ShardedSharedPool``'s
local pool; the ``[L, G/D, V, O]`` or ``[G2/D, L, V2, O]`` block of a
stack) and the matching slice of ``x``'s reduction dim, with the same
kernels at their local shapes (so the design cache is keyed on the local
shape), and the partial sums are added in float32 on the mesh axis's first
device in shard order, then cast once to the table dtype: the reference's
``psum``.  The fused and shared conv keep their in-kernel im2col: every
shard sees the whole image and fetches the patch columns of its segments
(the conv kernels' ``seg_offset`` / ``n_total``).  A mesh axis that does
not divide ``G`` replicates (the ``nn.module.ShardingRules`` fallback); a
generalized ``SegmentPlan`` refuses to shard.  Tables pre-sharded at
conversion (``core.pcilt.ShardedTables``) execute on their own mesh.
With ``return_stats`` on a sharded route, the counters come from one pass
over the whole ``x`` (every shard sees all of ``x``; its kernel's own
counters would count each element ``D`` times).

The depthwise conv1d maps the ``k`` taps of a channel onto one segment, so
one fetch of ``T[c, pack(codes)]`` is one output (``path="fused"`` runs
``kernels.ops.pcilt_fused_dwconv1d``, ``path="kernel"`` the host-packed
``kernels.ops.pcilt_dwconv1d``).  ``return_stats`` returns the
saturation ``(count, ratio)`` of the quantizer feeding the fetch; the kernel
routes reduce them in the kernel, the others on the side.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .quantization import QuantSpec, code_values, quantize, quantize_with_stats
from .offsets import offset_grid, pack_offsets
from .pcilt import (SharedGroupedTables, SharedTables, ShardedSharedPool,
                    ShardedTables, build_grouped_tables,
                    build_shared_grouped_tables, shard_shared_grouped_tables)

__all__ = ["conv_same_pads", "lut_lookup", "pcilt_linear", "im2col",
           "conv_offsets", "pcilt_conv2d", "build_dwconv_tables",
           "pcilt_depthwise_conv1d", "mesh_shard_count"]


@functools.lru_cache(maxsize=4096)
def conv_same_pads(h: int, w: int, kh: int, kw: int, stride: int = 1):
    """XLA's "SAME" pads for NHWC, as ``lax.conv_general_dilated`` takes
    them: output extent ``ceil(size / stride)``, ``pad_total = (out - 1) *
    stride + k - size`` split low side first as ``pad_total // 2``.  Not
    PyTorch's ``padding="same"``, which ignores the stride."""
    def axis(size: int, k: int):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return (total // 2, total - total // 2)

    return ((0, 0), axis(h, kh), axis(w, kw), (0, 0))


def pad_nhwc(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad an NHWC tensor by ``conv_same_pads``-style pairs."""
    (_, _), (hl, hh), (wl, wh), (_, _) = pads
    if not (hl or hh or wl or wh):
        return x
    return F.pad(x, (0, 0, wl, wh, hl, hh))


def lut_lookup(tables: torch.Tensor, offsets: torch.Tensor,
               path: str = "gather") -> torch.Tensor:
    """Fetch-and-sum ``sum_s T[s, off[..., s], :]``: tables ``[G, V, O]``,
    offsets ``[..., G]`` -> ``[..., O]``; ``path`` gather | onehot |
    kernel."""
    G, V, O = tables.shape
    if path == "gather":
        seg = torch.arange(G, device=tables.device)
        return tables[seg, offsets.long()].sum(-2)
    if path == "onehot":
        oh = F.one_hot(offsets.long(), V).to(tables.dtype)  # [..., G, V]
        return torch.einsum("...gv,gvo->...o", oh, tables)
    if path == "kernel":
        from repro_torch.kernels import ops

        flat = offsets.reshape(-1, G).to(torch.int32).contiguous()
        return ops.pcilt_gemv(flat, tables).reshape(*offsets.shape[:-1], O)
    raise ValueError(f"unknown path {path!r}")


def _pad_paired_phantom(x: torch.Tensor, n_pairs: int,
                        group: int) -> torch.Tensor:
    """Zero-pad ``x`` over the phantom segment of an odd-``G`` pairing (its
    table rows were built from zero weights, so any code fetches 0)."""
    want = n_pairs * 2 * group
    n = x.shape[-1]
    if n == want:
        return x
    if n == want - group:
        return F.pad(x, (0, group))
    raise ValueError(
        f"x trailing dim {n} matches neither G2*2*group = {want} nor the "
        f"odd-G phantom layout {want - group} for paired tables with "
        f"G2={n_pairs}, group={group}")


def _flat_fetch(x: torch.Tensor, fn, O: int, return_stats: bool):
    """Run a GEMV kernel wrapper ``fn(flat x)`` over ``x [..., n]`` and
    restore the leading dims (the stats, when returned, pass through)."""
    res = fn(x.reshape(-1, x.shape[-1]))
    if return_stats:
        out, count, ratio = res
        return out.reshape(*x.shape[:-1], O), count, ratio
    return res.reshape(*x.shape[:-1], O)


def mesh_shard_count(mesh, mesh_axis: str, n_segments: int) -> int:
    """How many segment shards a mesh yields; 1 means replicate: no mesh,
    no such axis, or an axis size that does not divide the segment count
    (the ``nn.module.ShardingRules`` fallback)."""
    if mesh is None or mesh_axis not in mesh.axis_names:
        return 1
    d = int(mesh.shape[mesh_axis])
    if d <= 1 or n_segments % d:
        return 1
    return d


def _own_mesh(tables: ShardedTables, mesh, mesh_axis: str):
    """The mesh a pre-sharded table executes on: its own; a ``mesh=``
    passed beside it must shard it alike."""
    if mesh is not None and mesh_axis in mesh.axis_names and \
            int(mesh.shape[mesh_axis]) != tables.n_shards:
        raise ValueError(
            f"tables were sharded {tables.n_shards} ways but mesh axis "
            f"{mesh_axis!r} has size {int(mesh.shape[mesh_axis])}")
    return tables.mesh, tables.mesh_axis


def _shard_pool_for(tables: SharedGroupedTables, n_shards: int, mesh,
                    mesh_axis: str) -> ShardedSharedPool:
    """A pool sharded at call time (the reference's offline build step,
    run here on the pool's concrete pointers), its blocks on the mesh
    axis's devices."""
    return shard_shared_grouped_tables(
        tables, n_shards, devices=mesh.axis_devices(mesh_axis))


def _devices(tables, mesh, mesh_axis: str):
    """The devices a layer's shards run on, in shard order."""
    if isinstance(tables, ShardedTables):
        return [s.device for s in tables.shards]
    return mesh.axis_devices(mesh_axis)


def _blocks(tables, n: int, seg_axis: int, devices, contiguous: bool):
    """The per-device blocks of ``tables`` (a :class:`ShardedTables`'s own
    shards, or a tensor cut into ``n`` contiguous blocks of ``seg_axis``);
    each made contiguous when a kernel reads it."""
    if isinstance(tables, ShardedTables):
        out = tables.shards
    else:
        size = tables.shape[seg_axis] // n
        out = [tables.narrow(seg_axis, d * size, size).to(dev)
               for d, dev in enumerate(devices)]
    return [t.contiguous() for t in out] if contiguous else out


def _psum(parts) -> torch.Tensor:
    """The reference's ``psum``: the shards' partial sums moved to the
    first one's device and added there in float32, in shard order (no
    atomics, one order run to run), cast once to the partials' dtype."""
    dev = parts[0].device
    acc = parts[0].to(torch.float32)  # a fresh partial: added to in place
    for p in parts[1:]:
        acc.add_(p.to(dev, torch.float32))
    return acc.to(parts[0].dtype)


def _x_blocks(flat: torch.Tensor, devices, contiguous: bool):
    """``flat [M, n]``'s reduction dim cut into one contiguous block a
    device."""
    w = flat.shape[-1] // len(devices)
    out = [flat[:, d * w:(d + 1) * w].to(dev)
           for d, dev in enumerate(devices)]
    return [x.contiguous() for x in out] if contiguous else out


def _sharded(x: torch.Tensor, run, O: int) -> torch.Tensor:
    """``x [..., n]`` flattened, ``run(flat)`` -> the per-shard partials,
    reduced and given back ``x``'s leading dims."""
    out = _psum(run(x.reshape(-1, x.shape[-1])))
    return out.reshape(*x.shape[:-1], O)


def _pcilt_linear_sharded(x, tables, spec, scale, group, path, mesh,
                          mesh_axis, paired: bool = False) -> torch.Tensor:
    """One fetch-and-sum layer over the mesh axis's segment shards: each
    device runs the unsharded route on its block of ``tables`` (dense, a
    :class:`ShardedTables` or a :class:`ShardedSharedPool`) and its slice of
    ``x``; :func:`_psum` adds the partials."""
    kernel = path in ("fused", "kernel", "shared")
    if isinstance(tables, ShardedSharedPool):
        devs = [p.device for p in tables.pools]
        O = tables.pools[0].shape[-1]

        def run(flat):
            return [pcilt_linear(xl, SharedGroupedTables(p, i, group), spec,
                                 scale, group, path=path)
                    for xl, p, i in zip(_x_blocks(flat, devs, kernel),
                                        tables.pools, tables.seg_idx)]
    else:
        devs = _devices(tables, mesh, mesh_axis)
        blocks = _blocks(tables, len(devs), 0, devs, kernel)
        O = tables.shape[-1]

        def run(flat):
            return [pcilt_linear(xl, t, spec, scale, group, path=path,
                                 paired=paired)
                    for xl, t in zip(_x_blocks(flat, devs, kernel), blocks)]
    return _sharded(x, run, O)


def _pcilt_linear_stacked_sharded(x, tables, layer, spec, scale, group, mesh,
                                  mesh_axis, paired: bool) -> torch.Tensor:
    """A stack sharded on its segment axis, the reference's two stacked
    routes: each device runs the stacked fused GEMV over its ``[L, G/D, V,
    O]`` block (or, ``paired``, the paired one over its segment-major
    ``[G2/D, L, V2, O]`` block) at ``layer``; one reduction a call."""
    from repro_torch.kernels import ops

    fn = ops.pcilt_fused_gemv_paired_stacked if paired \
        else ops.pcilt_fused_gemv_stacked
    devs = _devices(tables, mesh, mesh_axis)
    blocks = _blocks(tables, len(devs), 0 if paired else 1, devs, True)
    return _sharded(x, lambda flat: [
        fn(xl, t, layer, spec, scale, group)
        for xl, t in zip(_x_blocks(flat, devs, True), blocks)],
        tables.shape[-1])


def _with_stats(out, x, spec, scale, return_stats: bool):
    """A sharded route's result, with the counters of one pass over the
    whole ``x`` when asked."""
    if not return_stats:
        return out
    _, count, ratio = quantize_with_stats(x, spec, scale)
    return out, count, ratio


def _layer_of(tables, layer: int, axis: int):
    """Slice ``layer`` of a stack along ``axis``: a view of a tensor, or of
    each shard of a :class:`ShardedTables`."""
    if isinstance(tables, ShardedTables):
        return tables.layer(layer, axis)
    return tables.select(axis, layer)


def _pcilt_linear_paired(x, tables, spec, scale, group, path, mesh,
                         mesh_axis, stacked, return_stats):
    """The paired (TL1-style) routes of :func:`pcilt_linear`: ``tables`` is
    ``[G2, V2, out]`` or, with ``stacked=``, the segment-major
    ``[G2, L, V2, out]`` stack.  ``x`` is zero-padded over the odd-``G``
    phantom segment here, before any shard split (so the divisibility
    fallback is judged on the padded layout); the host-packed paths run a
    paired table as a grouped table of width ``2 * group``."""
    from repro_torch.kernels import ops

    if stacked is not None:
        if tables.dim() != 4:
            raise ValueError(
                f"paired stacked= expects seg-major [G2, L, V2, O] tables "
                f"(build_paired_stacked_tables), got shape "
                f"{tuple(tables.shape)}")
        G2, L, V2, O = tables.shape
        x = _pad_paired_phantom(x, G2, group)
        if path == "fused":
            if mesh_shard_count(mesh, mesh_axis, G2) > 1:
                return _with_stats(_pcilt_linear_stacked_sharded(
                    x, tables, stacked, spec, scale, group, mesh, mesh_axis,
                    paired=True), x, spec, scale, return_stats)
            return _flat_fetch(
                x, lambda f: ops.pcilt_fused_gemv_paired_stacked(
                    f, tables, stacked, spec, scale, group,
                    with_stats=return_stats), O, return_stats)
        # the reference route: the layer's [G2, V2, O] slice (the host-packed
        # kernel reads tables in place, so it gets a contiguous copy); the
        # reference runs it without its mesh, a pre-sharded stack on its own
        tab_l = _layer_of(tables, stacked, 1)
        if path == "kernel" and torch.is_tensor(tab_l):
            tab_l = tab_l.contiguous()
        return pcilt_linear(x, tab_l, spec, scale, 2 * group, path=path,
                            return_stats=return_stats)
    if tables.dim() != 3:
        raise ValueError(f"paired tables are [G2, V2, O] "
                         f"(build_paired_tables), got shape "
                         f"{tuple(tables.shape)}")
    G2, V2, O = tables.shape
    x = _pad_paired_phantom(x, G2, group)
    if path == "fused":
        if mesh_shard_count(mesh, mesh_axis, G2) > 1:
            return _with_stats(_pcilt_linear_sharded(
                x, tables, spec, scale, group, path, mesh, mesh_axis,
                paired=True), x, spec, scale, return_stats)
        return _flat_fetch(
            x, lambda f: ops.pcilt_fused_gemv_paired(
                f, tables, spec, scale, group, with_stats=return_stats), O,
            return_stats)
    return pcilt_linear(x, tables, spec, scale, 2 * group, path=path,
                        mesh=mesh, mesh_axis=mesh_axis,
                        return_stats=return_stats)


def _check_contiguous_segments(path: str, plan, n: int, n_segments: int,
                               group: int) -> None:
    """The in-kernel-packing paths take contiguous segments: refuse a plan
    on ``"shared"``, and tables built from a plan but dispatched without it
    (their ``G * group`` no longer covers ``x``)."""
    if plan is not None:
        raise ValueError(
            f"path={path!r} packs contiguous segments in-kernel and cannot "
            f"follow a generalized SegmentPlan; drop plan= (contiguous "
            f"default), use path='fused' (which gathers the plan index in "
            f"the kernel), or use the host-packed paths ('gather'/'onehot'/"
            f"'kernel'), which honor plan.pack()")
    if n != n_segments * group:
        raise ValueError(
            f"path={path!r} requires contiguous segments covering the "
            f"reduction dim: got x trailing dim {n} but G*group = "
            f"{n_segments}*{group} = {n_segments * group}. Tables built from "
            f"a generalized SegmentPlan (skipped/reused positions) need that "
            f"plan passed as plan= (path='fused' runs it via the in-kernel "
            f"plan gather; 'gather'/'onehot'/'kernel' via plan.pack())")


def pcilt_linear(x: torch.Tensor, tables, spec: QuantSpec, scale, group: int,
                 plan=None, path: str = "gather", mesh=None,
                 mesh_axis: str = "model", *,
                 stacked: Optional[int] = None, paired: bool = False,
                 return_stats: bool = False):
    """Quantize -> pack offsets -> fetch -> sum: ``x [..., n] -> [..., out]``.

    ``tables`` is a dense ``[G, V, out]`` tensor, a layer-stacked
    ``[L, G, V, out]`` one with ``stacked=`` (the layer index, a host int),
    a :class:`SharedGroupedTables` pool or a scalar :class:`SharedTables`
    (on ``"shared"``/``"gather"``, as its 1-wide segment pool: ``group``
    becomes 1).  With ``paired=True`` it is a paired ``[G2, V2, out]``
    table (``build_paired_tables``) or, stacked, the segment-major
    ``[G2, L, V2, out]`` stack (``build_paired_stacked_tables``); ``x``
    keeps the unpaired layout and ``group`` the unpaired width.  ``plan``
    is a generalized ``SegmentPlan`` for tables built from it (not with
    ``paired``, ``stacked`` or ``"shared"``).  ``path``: gather | onehot |
    kernel | fused | shared.  With ``mesh=`` the segment axis shards over
    ``mesh_axis`` (the module docstring); a pre-sharded
    :class:`ShardedTables` runs on its own mesh, a
    :class:`ShardedSharedPool` on ``path="shared"``/``"gather"`` only under
    the mesh it was cut for.  With ``return_stats`` the call returns
    ``(out, count, ratio)``; the unsharded fused stacked and paired kernels
    reduce them in the kernel, every other route on the side."""
    if isinstance(tables, SharedTables):
        if paired:
            raise ValueError(
                "paired tables are dense [G2, V2, O] arrays; scalar-level "
                "SharedTables pools have no paired layout")
        tables = tables.as_grouped_pool()
        group = tables.group
    if isinstance(tables, ShardedTables):
        mesh, mesh_axis = _own_mesh(tables, mesh, mesh_axis)
    pools = (SharedGroupedTables, ShardedSharedPool)
    if paired:
        if plan is not None:
            raise ValueError(
                "paired tables pack adjacent contiguous segment pairs; "
                "generalized SegmentPlans cannot pair — drop plan= or use "
                "the unpaired paths")
        if isinstance(tables, pools):
            raise ValueError(
                "paired=True consumes dense paired [G2, V2, O] tables "
                "(build_paired_tables); shared pools have no paired layout")
        if path == "shared":
            raise ValueError(
                "path='shared' has no paired variant; paired tables run "
                "path='fused' or the host-packed reference paths")
        return _pcilt_linear_paired(x, tables, spec, scale, group, path,
                                    mesh, mesh_axis, stacked, return_stats)
    if stacked is not None:
        if isinstance(tables, pools) or tables.dim() != 4:
            raise ValueError(
                f"stacked= executes layer-stacked dense [L, G, V, O] tables, "
                f"got {type(tables).__name__} "
                f"{tuple(getattr(tables, 'shape', ()))}")
        if plan is not None:
            raise ValueError(
                "stacked= packs contiguous segments (the tables of every "
                "layer share one segment grid); generalized SegmentPlans "
                "cannot ride the layer stack — drop plan= or slice the "
                "layer's tables and use the unstacked paths")
        L, G, V, O = tables.shape
        if path == "fused":
            from repro_torch.kernels import ops

            if mesh_shard_count(mesh, mesh_axis, G) > 1:
                _check_contiguous_segments(path, None, x.shape[-1], G, group)
                return _with_stats(_pcilt_linear_stacked_sharded(
                    x, tables, stacked, spec, scale, group, mesh, mesh_axis,
                    paired=False), x, spec, scale, return_stats)
            return _flat_fetch(
                x, lambda f: ops.pcilt_fused_gemv_stacked(
                    f, tables, stacked, spec, scale, group,
                    with_stats=return_stats), O, return_stats)
        tables = _layer_of(tables, stacked, 0)  # the reference path
    if return_stats:  # every other route: the stats on the side
        _, count, ratio = quantize_with_stats(x, spec, scale)
        out = pcilt_linear(x, tables, spec, scale, group, plan=plan,
                           path=path, mesh=mesh, mesh_axis=mesh_axis)
        return out, count, ratio
    if path not in ("gather", "onehot", "kernel", "fused", "shared"):
        raise ValueError(f"unknown path {path!r}")
    if isinstance(tables, ShardedSharedPool):
        _check_sharded_pool(tables, path, plan, x.shape[-1], group, mesh,
                            mesh_axis)
        return _pcilt_linear_sharded(x, tables, spec, scale, group, path,
                                     mesh, mesh_axis)
    shared = isinstance(tables, SharedGroupedTables)
    if path == "shared" and not shared:
        raise ValueError(
            "path='shared' executes a SharedGroupedTables pool; build one "
            "with build_shared_grouped_tables (got dense tables)")
    if path == "fused" and shared:
        raise ValueError(
            "path='fused' consumes dense [G, V, O] tables; use "
            "path='shared' for a SharedGroupedTables pool")
    if shared and path not in ("shared", "gather"):
        raise ValueError(f"SharedGroupedTables executes path='shared' or "
                         f"'gather', not {path!r}")
    n_segments = tables.n_segments if shared else tables.shape[0]
    if path == "fused" and plan is not None:
        if plan.n_segments != n_segments or plan.group != group:
            raise ValueError(
                f"plan grid [{plan.n_segments}, {plan.group}] does not "
                f"match tables' [{n_segments}, {group}] — tables must "
                f"be built from plan.gather_weights(...)")
    elif path in ("fused", "shared"):
        _check_contiguous_segments(path, plan, x.shape[-1], n_segments, group)
    D = mesh_shard_count(mesh, mesh_axis, n_segments)
    if D > 1:
        if plan is not None:
            # refuse rather than replicate silently: a generalized plan maps
            # positions arbitrarily, so it cannot shard along contiguous
            # segment blocks
            raise ValueError(
                "mesh execution shards contiguous segment blocks; a "
                "generalized SegmentPlan cannot be sharded — pass mesh=None "
                "to execute the plan replicated")
        if shared:
            tables = _shard_pool_for(tables, D, mesh, mesh_axis)
        return _pcilt_linear_sharded(x, tables, spec, scale, group, path,
                                     mesh, mesh_axis)
    if path in ("fused", "shared"):
        from repro_torch.kernels import ops

        if plan is not None:
            return _flat_fetch(x, lambda f: ops.pcilt_fused_gemv_plan(
                f, tables, plan.on(f.device), spec, scale, group),
                tables.shape[-1], False)
        if shared:
            return _flat_fetch(x, lambda f: ops.pcilt_shared_gemv(
                f, tables.pool, tables.seg_idx, spec, scale, tables.group),
                tables.pool.shape[-1], False)
        return _flat_fetch(x, lambda f: ops.pcilt_fused_gemv(
            f, tables, spec, scale, group), tables.shape[-1], False)
    codes = quantize(x, spec, scale)
    offsets = (pack_offsets(codes, spec.bits, group) if plan is None
               else plan.pack(codes, spec.bits))
    if shared:
        return tables.lookup(offsets)
    return lut_lookup(tables, offsets, path)


def _check_sharded_pool(tables: ShardedSharedPool, path, plan, n: int,
                        group: int, mesh, mesh_axis: str) -> None:
    """The reference's refusals of a :class:`ShardedSharedPool` operand."""
    if path not in ("shared", "gather"):
        raise ValueError(
            f"a ShardedSharedPool executes path='shared' or 'gather', "
            f"not {path!r}")
    if plan is not None:
        raise ValueError(
            "a ShardedSharedPool was built over contiguous segment "
            "blocks; generalized SegmentPlans cannot execute on sharded "
            "pools — use the unsharded SharedGroupedTables with a "
            "host-packed path instead")
    if n != tables.n_segments * group:
        raise ValueError(
            f"x trailing dim {n} != G*group = "
            f"{tables.n_segments}*{group} = {tables.n_segments * group} "
            f"for this ShardedSharedPool")
    _check_pool_mesh(tables, mesh, mesh_axis)


def _check_pool_mesh(tables: ShardedSharedPool, mesh, mesh_axis: str) -> None:
    if mesh is None or mesh_axis not in mesh.axis_names:
        raise ValueError(
            "a ShardedSharedPool is a mesh operand; pass mesh= (and the "
            "mesh_axis its pools were sharded for), or execute the "
            "unsharded SharedGroupedTables instead")
    if int(mesh.shape[mesh_axis]) != tables.n_shards:
        raise ValueError(
            f"ShardedSharedPool was built for {tables.n_shards} shards "
            f"but mesh axis {mesh_axis!r} has size "
            f"{int(mesh.shape[mesh_axis])}; rebuild with "
            f"shard_shared_grouped_tables(st, {int(mesh.shape[mesh_axis])})")


def _conv_pads(x: torch.Tensor, kh: int, kw: int, stride: int,
               padding: str):
    if padding == "SAME":
        return conv_same_pads(x.shape[1], x.shape[2], kh, kw, stride)
    if padding == "VALID":
        return ((0, 0),) * 4
    raise ValueError(f"padding must be SAME|VALID, got {padding!r}")


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC ``[B, H, W, C] -> [B, Ho, Wo, kh*kw*C]`` patches, flattened
    ``[kh, kw, C]`` (the filter flattening of :func:`pcilt_conv2d`); SAME
    pads the float signal with 0.0 by :func:`conv_same_pads`."""
    xp = pad_nhwc(x, _conv_pads(x, kh, kw, stride, padding))
    B, H, W, C = xp.shape
    Ho = (H - kh) // stride + 1
    Wo = (W - kw) // stride + 1
    cols = [xp[:, i:i + (Ho - 1) * stride + 1:stride,
               j:j + (Wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1).reshape(B, Ho, Wo, kh * kw * C)


def flatten_filters(filters: torch.Tensor, group: int) -> torch.Tensor:
    """``[kh, kw, Cin, Cout]`` -> ``[n + pad, Cout]`` with ``pad`` zero rows
    aligning the reduction length to ``group``."""
    kh, kw, cin, cout = filters.shape
    n = kh * kw * cin
    wflat = filters.reshape(n, cout)
    pad = (-n) % group
    if pad:
        wflat = torch.cat([wflat, wflat.new_zeros((pad, cout))], 0)
    return wflat


def conv_offsets(x: torch.Tensor, spec: QuantSpec, scale, group: int,
                 kh: int, kw: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """The host-packed conv's activation side: im2col the float image,
    quantize, give the group-alignment slots code 0 (as the conv kernels
    do; they meet zero-weight table rows) and pack -> ``[B, Ho, Wo, G]``
    int32 offsets."""
    codes = quantize(im2col(x, kh, kw, stride, padding), spec, scale)
    pad_n = (-codes.shape[-1]) % group
    if pad_n:
        codes = F.pad(codes, (0, pad_n))
    return pack_offsets(codes, spec.bits, group)


def _pcilt_conv2d_sharded_kernel(x, tables, spec, scale, group, kh, kw,
                                 stride, padding, path, mesh, mesh_axis):
    """The fused or shared conv over the mesh axis's segment shards, the
    im2col still in the kernel: every device takes the whole image, its
    ``[G/D, V, O]`` block (or local pool) and its first global segment
    ``seg_offset = d * G/D``, and its kernel fetches the patch columns of
    its own segments (``n_total`` is the global padded patch length);
    :func:`_psum` adds the partials."""
    from repro_torch.kernels import ops

    if isinstance(tables, ShardedSharedPool):
        _check_pool_mesh(tables, mesh, mesh_axis)
        n_seg, D = tables.n_segments, tables.n_shards
        devs = [p.device for p in tables.pools]
    else:
        n_seg = tables.shape[0]
        devs = _devices(tables, mesh, mesh_axis)
        D = len(devs)
    n_total, Gl = n_seg * group, n_seg // D
    kw_args = dict(stride=stride, padding=padding, n_total=n_total)
    if path == "fused":
        parts = [ops.pcilt_fused_conv2d(x.to(dev), t, spec, scale, group, kh,
                                        kw, seg_offset=d * Gl, **kw_args)
                 for d, (dev, t) in enumerate(zip(
                     devs, _blocks(tables, D, 0, devs, True)))]
    else:
        parts = [ops.pcilt_shared_conv2d(x.to(dev), p, i, spec, scale, group,
                                         kh, kw, seg_offset=d * Gl, **kw_args)
                 for d, (dev, p, i) in enumerate(zip(devs, tables.pools,
                                                     tables.seg_idx))]
    return _psum(parts)


def pcilt_conv2d(x: torch.Tensor, filters: torch.Tensor, spec: QuantSpec,
                 scale, group: int, stride: int = 1, padding: str = "SAME",
                 tables=None, path: str = "gather", mesh=None,
                 mesh_axis: str = "model") -> torch.Tensor:
    """PCILT convolution, NHWC ``[B, H, W, Cin] -> [B, Ho, Wo, Cout]``.

    ``filters [kh, kw, Cin, Cout]``.  ``tables`` are the pre-built dense
    ``[G, V, Cout]`` tables or, for ``path="shared"``, a
    :class:`SharedGroupedTables` pool; when omitted they are built here.
    ``"fused"``/``"shared"`` run the conv kernels on the spatially padded
    float image; ``"gather"``/``"onehot"``/``"kernel"`` pack the offsets on
    the host by :func:`conv_offsets` and fetch them by :func:`lut_lookup`.
    With ``mesh=`` the segment axis (the flattened ``kh*kw*Cin`` receptive
    field) shards over ``mesh_axis``: the conv kernels keep their
    in-kernel im2col on every shard (their ``seg_offset``), the host paths
    extract the patches by :func:`im2col` and run the sharded
    :func:`pcilt_linear`.  Pre-sharded tables (:class:`ShardedTables`,
    :class:`ShardedSharedPool`) are accepted.
    """
    kh, kw, cin, cout = filters.shape
    n = kh * kw * cin
    pad_n = (-n) % group
    if tables is None:
        wflat = flatten_filters(filters, group)
        build = build_shared_grouped_tables if path == "shared" \
            else build_grouped_tables
        tables = build(wflat, spec, scale, group)
    if isinstance(tables, ShardedTables):
        mesh, mesh_axis = _own_mesh(tables, mesh, mesh_axis)
    pools = (SharedGroupedTables, ShardedSharedPool)
    shared = isinstance(tables, pools)
    if path == "shared" and not shared:
        raise ValueError(
            "path='shared' executes a SharedGroupedTables pool; build one "
            "with build_shared_grouped_tables (got dense tables)")
    if path == "fused" and shared:
        raise ValueError(
            "path='fused' consumes dense [G, V, O] tables; use "
            "path='shared' for a SharedGroupedTables pool")
    n_seg = tables.n_segments if shared else tables.shape[0]
    sharded = isinstance(tables, ShardedSharedPool) or \
        mesh_shard_count(mesh, mesh_axis, n_seg) > 1
    if path in ("fused", "shared"):
        from repro_torch.kernels import ops

        if n + pad_n != n_seg * group:
            raise ValueError(
                f"path={path!r} requires contiguous segments covering the "
                f"patch: kh*kw*Cin = {n} (+{pad_n} alignment slots) but "
                f"G*group = {n_seg}*{group}")
        if sharded:
            if isinstance(tables, SharedGroupedTables):
                tables = _shard_pool_for(
                    tables, mesh_shard_count(mesh, mesh_axis, n_seg), mesh,
                    mesh_axis)
            return _pcilt_conv2d_sharded_kernel(
                x, tables, spec, scale, group, kh, kw, stride, padding, path,
                mesh, mesh_axis)
        if path == "shared":
            return ops.pcilt_shared_conv2d(
                x, tables.pool, tables.seg_idx, spec, scale, tables.group,
                kh, kw, stride=stride, padding=padding)
        return ops.pcilt_fused_conv2d(x, tables, spec, scale, group, kh, kw,
                                      stride=stride, padding=padding)
    if shared and path != "gather":
        raise ValueError(f"SharedGroupedTables executes path='shared' or "
                         f"'gather', not {path!r}")
    if sharded:
        patches = im2col(x, kh, kw, stride, padding)
        if pad_n:
            patches = F.pad(patches, (0, pad_n))
        return pcilt_linear(patches, tables, spec, scale, group, path=path,
                            mesh=mesh, mesh_axis=mesh_axis)
    offsets = conv_offsets(x, spec, scale, group, kh, kw, stride, padding)
    if shared:
        return tables.lookup(offsets)
    return lut_lookup(tables, offsets, path)


def _dwconv_pads(k: int, padding: str):
    try:
        return {"CAUSAL": (k - 1, 0),
                "SAME": ((k - 1) // 2, k - 1 - (k - 1) // 2),
                "VALID": (0, 0)}[padding]
    except KeyError:
        raise ValueError(
            f"padding must be CAUSAL|SAME|VALID, got {padding!r}") from None


def build_dwconv_tables(filters: torch.Tensor, spec: QuantSpec,
                        scale) -> torch.Tensor:
    """Per-channel depthwise-conv1d PCILTs: ``[k, C]`` filters -> ``[C, V]``
    (slot ``j`` of an offset is tap ``j``)."""
    k, _ = filters.shape
    grid = offset_grid(spec.bits, k, device=filters.device).long()
    vals = code_values(spec, scale, device=filters.device)[grid]  # [V, k]
    return torch.einsum("vk,kc->cv", vals, filters.to(vals.dtype))


def pcilt_depthwise_conv1d(x: torch.Tensor, filters: torch.Tensor,
                           spec: QuantSpec, scale,
                           tables: Optional[torch.Tensor] = None,
                           path: str = "gather", padding: str = "CAUSAL",
                           return_stats: bool = False):
    """Depthwise conv1d where one fetch produces one output element.

    ``x [B, T, C]``, ``filters [k, C]``; ``padding`` CAUSAL | SAME | VALID.
    ``path="fused"`` runs the fused kernel wrapper; ``"gather"``,
    ``"onehot"`` and ``"kernel"`` (the host-packed kernel,
    ``kernels.ops.pcilt_dwconv1d``) build the offset tensor explicitly."""
    k, C = filters.shape
    if tables is None:
        tables = build_dwconv_tables(filters, spec, scale)
    if path == "fused":
        from repro_torch.kernels import ops

        return ops.pcilt_fused_dwconv1d(x, tables, spec, scale, k,
                                        padding=padding,
                                        with_stats=return_stats)
    if path not in ("gather", "onehot", "kernel"):
        raise ValueError(f"unknown path {path!r}")
    if return_stats:
        codes, count, ratio = quantize_with_stats(x, spec, scale)
    else:
        codes = quantize(x, spec, scale)
    lo, hi = _dwconv_pads(k, padding)
    # the reference pads the codes with 0 here (not the signal with 0.0,
    # as the fused kernel does): the two differ at CAUSAL/SAME edges
    padded = F.pad(codes.to(torch.int32), (0, 0, lo, hi))
    To = padded.shape[1] - k + 1
    off = sum(padded[:, j:j + To] << (j * spec.bits) for j in range(k))
    if path == "gather":
        out = tables[torch.arange(C, device=tables.device), off.long()]
    elif path == "onehot":
        oh = F.one_hot(off.long(), tables.shape[-1]).to(tables.dtype)
        out = torch.einsum("btcv,cv->btc", oh, tables)
    else:
        from repro_torch.kernels import ops

        out = ops.pcilt_dwconv1d(off.contiguous(), tables)
    if return_stats:
        return out, count, ratio
    return out
