"""Declarative parameters (port of ``repro.nn.module``'s ParamSpec,
``materialize`` and ``count_params``), layer views of a stacked tree, the
activation-checkpoint policies the training losses apply per layer, and
the sharding rules of the PCILT tables (``ShardingRules``,
``pcilt_table_pspec``, ``pcilt_table_sharding``).

A model declares its parameters as a tree of :class:`ParamSpec` (shape,
dtype, init recipe); :func:`materialize` draws them.  Each leaf draws from a
numpy generator seeded by ``(seed, crc32(path))``, so a leaf's values depend
on the seed and its place in the tree only.  The numbers differ from the JAX
package's (other generator); parity tests carry the JAX parameters across
instead (``repro_torch.interop.params_from_jax``).

The torch counterpart of a ``NamedSharding`` is a :class:`TablePlacement`:
the mesh (``launch.mesh.Mesh``), the mesh axis, the table's segment axis
and the shard count.  :func:`shard_tensor` cuts a tensor into contiguous
per-device blocks under a placement, :func:`join_shards` joins them again.
Only the table rules are ported; parameter sharding
(``logical_to_partition_spec``, ``shardings``, ``shape_structs``) waits
for ``Ctx``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.interop import resolve_device

__all__ = ["ParamSpec", "materialize", "stack_specs", "count_params",
           "layer_view", "remat", "ShardingRules", "DEFAULT_RULES",
           "PCILT_TABLE_AXES", "pcilt_table_pspec", "pcilt_table_sharding",
           "TablePlacement", "shard_tensor", "join_shards"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape + init recipe (fan_in | normal | embed | zeros
    | ones) + scale."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "fan_in"
    scale: float = 1.0


def _draw(spec: ParamSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.init == "zeros":
        return np.zeros(spec.shape, np.float32)
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    if spec.init in ("normal", "embed"):
        return rng.standard_normal(spec.shape, np.float32) * spec.scale
    if spec.init == "fan_in":
        # the reference's recipe, stacked layer axis included in the fan-in
        fan_in = spec.shape[0] if len(spec.shape) == 1 else \
            math.prod(spec.shape[:-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return rng.standard_normal(spec.shape, np.float32) * np.float32(std)
    raise ValueError(f"unknown init {spec.init}")


def materialize(specs, seed: int = 0, *, device="cuda", _path: str = ""):
    """Concrete parameters for a spec tree (nested dicts of ParamSpec)."""
    dev = resolve_device(device)
    if isinstance(specs, ParamSpec):
        rng = np.random.default_rng([seed, zlib.crc32(_path.encode())])
        arr = np.ascontiguousarray(_draw(specs, rng), np.float32)
        return torch.from_numpy(arr).to(device=dev, dtype=specs.dtype)
    return {k: materialize(v, seed, device=dev, _path=f"{_path}/{k}")
            for k, v in specs.items()}


def stack_specs(tree, n: int):
    """Prepend a stacked ``layers`` dim to every ParamSpec in the tree."""
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n, *tree.shape))
    return {k: stack_specs(v, n) for k, v in tree.items()}


def count_params(specs) -> int:
    """The number of parameters a spec tree declares."""
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def layer_view(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, l) for k, v in tree.items()}
    return tree[l]


#: the matmuls ``"dots"`` keeps (JAX's ``dots_with_no_batch_dims_saveable``:
#: contractions without batch dimensions; ``bmm`` has one)
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    saved = {getattr(torch.ops.aten, n).default for n in _DOTS}
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under an activation-checkpoint policy (the reference's
    ``remat_policy``): ``"none"`` keeps every activation; ``"full"`` keeps
    only ``fn``'s inputs and recomputes the rest in the backward pass
    (``jax.checkpoint_policies.nothing_saveable``); ``"dots"`` keeps the
    outputs of the matmuls without batch dimensions and recomputes the rest
    (``dots_with_no_batch_dims_saveable``).  The forward values do not
    depend on the policy."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r} (none | dots | full)")


# ----------------------------------------------------------------------------
# Sharding rules of the PCILT tables
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or a tuple of mesh axes)."""

    rules: Dict[str, Any]
    mesh_axis_sizes: Dict[str, int]

    @staticmethod
    def for_mesh(mesh, rules: Optional[Dict[str, Any]] = None
                 ) -> "ShardingRules":
        return ShardingRules(rules=dict(rules or DEFAULT_RULES),
                             mesh_axis_sizes=dict(mesh.shape))

    def mesh_axes_for(self, logical: Optional[str], dim: int):
        """One logical axis resolved to its mesh axes, or None when the
        axis has no rule, its mesh axes are absent, or their product does
        not divide ``dim`` (the divisibility fallback: replicate)."""
        if logical is None:
            return None
        target = self.rules.get(logical)
        if target is None:
            return None
        axes = target if isinstance(target, tuple) else (target,)
        axes = tuple(a for a in axes if a in self.mesh_axis_sizes)
        if not axes:
            return None
        total = math.prod(self.mesh_axis_sizes[a] for a in axes)
        if dim % total != 0:
            return None
        return axes if len(axes) > 1 else axes[0]


#: the reference's rule table: batch over (pod,) data, tensor-parallel dims
#: over model, FSDP over data on the embed dim; ``"table_seg"`` is the
#: segment axis of the PCILT tables (and of a ``ShardedSharedPool``'s shard
#: stack), sharded over the tensor-parallel axis
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq_sp": "model",
    "cache_seq": ("pod", "data"),
    "embed": ("data", "pod"),
    "embed_tp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "ssm_heads": "model",
    "layers": None,
    "stage": "stage",
    "table_seg": "model",
}

#: logical axes of a grouped table ``[G, V, O]``: only the segment axis
#: shards; every device fetches from the whole value axis, and the out
#: axis rides the reduction of the partial sums
PCILT_TABLE_AXES: Tuple[Optional[str], ...] = ("table_seg", None, None)


def pcilt_table_pspec(G: int, ndim: int = 3,
                      rules: Optional[ShardingRules] = None,
                      mesh_axis: Optional[str] = None,
                      seg_axis: int = 0) -> Tuple:
    """The partition spec (a tuple, one entry an axis) of a table operand
    whose segment axis is position ``seg_axis``: ``seg_axis=0`` for
    ``[G, V, O]`` tables, a shard stack and the segment-major paired
    ``[G2, L, V2, O]`` stack, ``1`` for the layer-major ``[L, G, V, O]``
    stack.  The segment axis takes the ``"table_seg"`` rule (``mesh_axis``
    overrides it) with the divisibility fallback; every other axis
    replicates."""
    if mesh_axis is not None and rules is not None:
        rules = ShardingRules(rules={"table_seg": mesh_axis},
                              mesh_axis_sizes=rules.mesh_axis_sizes)
    resolved = rules.mesh_axes_for("table_seg", G) if rules is not None \
        else None
    parts = [None] * ndim
    parts[seg_axis] = resolved
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    """Where a table's shards live: ``n_shards`` contiguous blocks of its
    ``seg_axis``, block ``d`` on ``devices[d]`` (one block on the mesh axis's
    first device when the table replicates)."""

    mesh: Any
    mesh_axis: Optional[str]
    seg_axis: int
    n_shards: int

    @property
    def devices(self) -> List[torch.device]:
        if self.mesh_axis is None:
            return [self.mesh.devices.reshape(-1)[0]]
        return self.mesh.axis_devices(self.mesh_axis)


def pcilt_table_sharding(mesh, G: int, ndim: int = 3,
                         rules: Optional[ShardingRules] = None,
                         mesh_axis: Optional[str] = None,
                         seg_axis: int = 0) -> TablePlacement:
    """The placement of a table operand on ``mesh`` (its segment axis
    sharded; the reference's ``NamedSharding``)."""
    rules = rules or ShardingRules.for_mesh(mesh)
    axis = pcilt_table_pspec(G, ndim, rules, mesh_axis, seg_axis)[seg_axis]
    if isinstance(axis, tuple):
        raise ValueError(f"a table's segment axis shards over one mesh "
                         f"axis, got {axis}")
    n = 1 if axis is None else int(mesh.shape[axis])
    return TablePlacement(mesh, axis, seg_axis, n)


def shard_tensor(t: torch.Tensor,
                 placement: TablePlacement) -> List[torch.Tensor]:
    """``t`` cut into ``placement.n_shards`` contiguous blocks of its
    segment axis, block ``d`` contiguous on ``placement.devices[d]`` (views
    of ``t``, not copies, when the axis is the leading one and every block
    stays on ``t``'s device)."""
    ax, n = placement.seg_axis, placement.n_shards
    if t.shape[ax] % n:
        raise ValueError(f"{n} shards do not divide axis {ax} of "
                         f"{tuple(t.shape)}")
    size = t.shape[ax] // n
    devs = placement.devices
    # a view would keep the whole of t alive on its device: copy each block
    # unless every block stays on t's device
    home = all(torch.device(d) == t.device for d in devs)
    return [t.narrow(ax, d * size, size).contiguous() if home
            else t.narrow(ax, d * size, size).to(dev, copy=True)
            .contiguous() for d, dev in enumerate(devs)]


def join_shards(shards: Sequence[torch.Tensor],
                seg_axis: int = 0) -> torch.Tensor:
    """The blocks of :func:`shard_tensor` joined on ``seg_axis`` on the
    first shard's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=seg_axis)
