"""Device selection and the numpy <-> torch bridge.

The bridge is how both packages compute on identical weights and tables: the
JAX side hands its parameter tree and PCILT bundle over as numpy arrays (any
object ``np.asarray`` accepts), and :func:`params_from_jax` /
:func:`bundle_from_jax` rebuild them as tensors in the layout the port uses.
bf16 arrays cross as raw 16-bit words, so bytes (and CRC-32 records) are
preserved exactly.  With ``mesh=`` (a ``launch.mesh.Mesh``) the
sharded tables of a JAX run (a ``ShardedSharedPool``, a bundle converted
with a mesh) cross as the port's sharded types, each shard on its device
of the mesh axis, and with ``shardings=`` a parameter tree crosses placed
(``nn.module.Placed`` leaves).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.quantization import QuantSpec

__all__ = ["resolve_device", "to_torch", "to_numpy", "tree_map", "tree_leaves",
           "params_from_jax", "tables_from_jax", "learnable_from_jax",
           "bundle_from_jax"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Never falls back to the CPU on
    its own: asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def to_torch(a, device="cpu") -> torch.Tensor:
    """One array -> a contiguous tensor on ``device`` (bf16 bit-preserving)."""
    a = np.asarray(a)
    arr = np.ascontiguousarray(a).reshape(a.shape)  # 0-d stays 0-d
    if not arr.flags.writeable:  # e.g. a JAX array's host view
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a host numpy array (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only callers that compare bf16 arrays need it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of a tree of dicts, lists and tuples (and
    the matching nodes of the parallel trees ``rest``, whose nodes below
    ``tree``'s leaves go to ``fn`` whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def params_from_jax(np_tree, device="cuda", *,
                    shardings=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves) as tensors; with
    ``shardings`` (``nn.module.shardings(specs, mesh)``) each leaf is cut
    on the host and its blocks placed on the mesh (``nn.module.place``:
    no device holds a sharded leaf whole)."""
    if shardings is not None:
        from .nn.module import place

        return place(tree_map(lambda a: to_torch(a, "cpu"), np_tree),
                     shardings)
    dev = resolve_device(device)
    return tree_map(lambda a: to_torch(a, dev), np_tree)


def _shard_devices(mesh, mesh_axis: str, n: int, dev):
    if mesh is None:
        return [dev] * n
    devs = mesh.axis_devices(mesh_axis)
    if len(devs) != n:
        raise ValueError(f"{n} shards on a mesh axis {mesh_axis!r} of "
                         f"{len(devs)} devices")
    return devs


def tables_from_jax(tables, device="cuda", *, mesh=None,
                    mesh_axis: str = "model"):
    """Dense ``[G, V, O]`` tables, ``SharedGroupedTables`` pools (any object
    with ``pool``, ``seg_idx`` and ``group``), ``ShardedSharedPool`` pools
    (``pools``, ``seg_idx``, ``group``, ``shard_cards``; shard ``d`` on the
    mesh axis's device ``d``, or all on ``device`` without a mesh) and
    scalar ``SharedTables`` pools (``pool``, ``w_idx``, ``unique_w``,
    ``value_pool``) of the JAX package, or a dict of them such as
    ``PaperCNN.build_tables`` returns, as the port's.  (A ``SegmentPlan``
    needs no converter: its index is a numpy array in both packages.)"""
    from .core.pcilt import ShardedSharedPool, SharedGroupedTables, SharedTables

    dev = resolve_device(device)
    if isinstance(tables, dict):
        return {k: tables_from_jax(v, dev, mesh=mesh, mesh_axis=mesh_axis)
                for k, v in tables.items()}
    if hasattr(tables, "pools") and hasattr(tables, "shard_cards"):
        pools, idx = np.asarray(tables.pools), np.asarray(tables.seg_idx,
                                                          np.int32)
        devs = _shard_devices(mesh, mesh_axis, pools.shape[0], dev)
        return ShardedSharedPool(
            pools=[to_torch(p, d) for p, d in zip(pools, devs)],
            seg_idx=[to_torch(i, d) for i, d in zip(idx, devs)],
            group=int(tables.group),
            shard_cards=tuple(int(c) for c in tables.shard_cards))
    if hasattr(tables, "w_idx"):
        vp = tables.value_pool
        return SharedTables(
            pool=to_torch(tables.pool, dev),
            w_idx=to_torch(np.asarray(tables.w_idx, np.int32), dev),
            unique_w=to_torch(tables.unique_w, dev),
            value_pool=None if vp is None else to_torch(vp, dev))
    if hasattr(tables, "pool") and hasattr(tables, "seg_idx"):
        return SharedGroupedTables(
            pool=to_torch(tables.pool, dev),
            seg_idx=to_torch(np.asarray(tables.seg_idx, np.int32), dev),
            group=int(tables.group))
    return to_torch(tables, dev)


def learnable_from_jax(np_params, device="cuda") -> Dict[str, torch.Tensor]:
    """The parameter dict of ``repro.core.init_learnable_pcilt`` (numpy
    leaves) as the port's: tensors on ``device`` that require grad."""
    dev = resolve_device(device)
    return {k: to_torch(v, dev).requires_grad_() for k, v in np_params.items()}


def _host_scales(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _spec(s) -> QuantSpec:
    return QuantSpec(bits=int(s.bits), symmetric=bool(s.symmetric))


def _stack_from_jax(a, dev, paired: bool, mesh, mesh_axis: str):
    """One projection stack; with a mesh that divides its segment axis,
    cut into its shards (``[L, G/D, V, O]``, paired ``[G2/D, L, V2, O]``),
    each placed from the host on its device."""
    from .core.pcilt import ShardedTables
    from .core.lut_layers import mesh_shard_count

    a = np.asarray(a)
    ax = 0 if paired else 1
    D = mesh_shard_count(mesh, mesh_axis, a.shape[ax])
    if D == 1:
        return to_torch(a, dev)
    size = a.shape[ax] // D
    return ShardedTables(
        [to_torch(np.take(a, range(d * size, (d + 1) * size), axis=ax), d_)
         for d, d_ in enumerate(mesh.axis_devices(mesh_axis))],
        ax, mesh, mesh_axis)


def bundle_from_jax(np_bundle, device="cuda", *, mesh=None,
                    mesh_axis: str = "model") -> Dict[str, Any]:
    """A ``MambaLM.build_pcilt`` bundle of the JAX package as the port's
    bundle: tables on ``device`` (layer-major or, paired, segment-major
    projection stacks), calibrated scales as host float32 (the kernels take
    them by value), the conversion-time integrity record as is.  With
    ``mesh=`` the projection stacks are sharded over ``mesh_axis`` as
    ``convert_mamba_decode(mesh=)`` shards them (a JAX bundle converted
    with a mesh crosses as numpy, whole, and is cut here)."""
    dev = resolve_device(device)
    b = np_bundle
    out = {"tables": to_torch(b["tables"], dev),
           "scale": float(np.float32(np.asarray(b["scale"]))),
           "spec": _spec(b["spec"])}
    proj = b.get("proj")
    if proj is not None:
        paired = bool(proj.get("paired", False))
        out["proj"] = {
            "tables": {k: _stack_from_jax(v, dev, paired, mesh, mesh_axis)
                       for k, v in proj["tables"].items()},
            "scales": {k: _host_scales(v) for k, v in proj["scales"].items()},
            "spec": _spec(proj["spec"]), "group": int(proj["group"]),
            "path": proj.get("path", "fused"), "paired": paired,
            "mesh": mesh, "mesh_axis": mesh_axis}
    head = b.get("head")
    if head is not None:
        out["head"] = {
            "pool": to_torch(head["pool"], dev),
            "seg_idx": to_torch(np.asarray(head["seg_idx"], np.int32), dev),
            "group": int(head["group"]), "spec": _spec(head["spec"]),
            "scale": float(np.float32(np.asarray(head["scale"]))),
            "kernel_q": to_torch(head["kernel_q"], dev), "n": int(head["n"])}
    if "integrity" in b:
        out["integrity"] = tree_map(int, b["integrity"])
    return out
