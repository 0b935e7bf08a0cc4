"""Declarative parameters (port of ``repro.nn.module``'s ParamSpec,
``materialize`` and ``count_params``), layer views of a stacked tree, the
activation-checkpoint policies the training losses apply per layer, and
the sharding of parameters, caches and PCILT tables over a mesh.

A model declares its parameters as a tree of :class:`ParamSpec` (shape,
dtype, init recipe); :func:`materialize` draws them.  Each leaf draws from a
numpy generator seeded by ``(seed, crc32(path))``, so a leaf's values depend
on the seed and its place in the tree only.  The numbers differ from the JAX
package's (other generator); parity tests carry the JAX parameters across
instead (``repro_torch.interop.params_from_jax``).

Every spec carries the reference's logical axes (``"embed"``,
``"heads"``, ``"mlp"``, ``"vocab"``, ...); :class:`ShardingRules` maps them
onto mesh axes (:data:`DEFAULT_RULES`), and
:func:`logical_to_partition_spec` resolves one leaf with the reference's
divisibility fallback and its one-dim-per-mesh-axis rule.  The torch
counterpart of a ``NamedSharding`` is a :class:`TablePlacement`: the
mesh (``launch.mesh.Mesh``) and the partition spec.  :func:`shardings` gives a spec tree's placements,
:func:`shape_structs` its meta tensors, :func:`place` places a tree of
whole tensors (each leaf a :class:`Placed`: one contiguous block a mesh
coordinate, a replicated block held once per distinct device) and
:func:`join` joins one again.  A table's placement also names its segment
axis: :func:`shard_tensor` cuts a table into its per-device blocks,
:func:`join_shards` joins them (``core.pcilt.ShardedTables``).
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

from repro_torch.interop import resolve_device, tree_leaves

from . import coords

__all__ = ["ParamSpec", "materialize", "stack_specs", "count_params",
           "layer_view", "remat", "ShardingRules", "DEFAULT_RULES",
           "PCILT_TABLE_AXES", "pcilt_table_pspec", "pcilt_table_sharding",
           "TablePlacement", "shard_tensor", "join_shards",
           "logical_to_partition_spec", "shardings", "shape_structs",
           "spec_bytes", "Placed", "place", "join", "check_placed_bytes",
           "fallback_leaves", "device_bytes"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape + init recipe (fan_in | normal | embed | zeros
    | ones) + scale, and its logical axes (keyword-only, one a dim: the
    names :data:`DEFAULT_RULES` maps onto mesh axes, or None)."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "fan_in"
    scale: float = 1.0
    _: dataclasses.KW_ONLY
    axes: Tuple[Optional[str], ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


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
        arr = np.ascontiguousarray(_draw(specs, rng), np.float32) \
            .reshape(specs.shape)  # a 0-d spec stays 0-d
        return torch.from_numpy(arr).to(device=dev, dtype=specs.dtype)
    return {k: materialize(v, seed, device=dev, _path=f"{_path}/{k}")
            for k, v in specs.items()}


def stack_specs(tree, n: int):
    """Prepend a stacked ``"layers"`` dim to every ParamSpec in the
    tree."""
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n, *tree.shape),
                                   axes=("layers", *tree.axes))
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
    if isinstance(tree, Placed):
        return tree.select(0, l)
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


def _axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition-spec entry (major first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    """Where a leaf lives on a mesh: the torch counterpart of the
    reference's ``NamedSharding``.  ``spec`` has one entry a dim: None
    (replicated), a mesh axis, or a tuple of mesh axes (major first).  Dim
    ``k`` is cut into as many contiguous blocks as its axes have devices,
    and the device at mesh coordinate ``c`` holds the block that ``c``'s
    coordinates on those axes name (:meth:`block_index`).

    A table operand's placement (:func:`pcilt_table_sharding`) also names
    its ``seg_axis``, which it keeps when the axis falls back to
    replication; ``mesh_axis``, ``n_shards`` and ``devices`` describe that
    axis (``core.pcilt.ShardedTables``)."""

    mesh: Any
    spec: Tuple
    seg_axis: Optional[int] = None

    @functools.cached_property
    def counts(self) -> Tuple[int, ...]:
        """The number of blocks each dim is cut into."""
        return tuple(math.prod(int(self.mesh.shape[a]) for a in _axes_of(e))
                     for e in self.spec)

    def dim_blocks(self, dim: int) -> int:
        """The number of blocks dim ``dim`` is cut into."""
        return self.counts[dim]

    @functools.cached_property
    def _index(self) -> Dict[Tuple[int, ...], Tuple[int, ...]]:
        names, sizes = self.mesh.axis_names, self.mesh.devices.shape
        out = {}
        for coord in self.mesh.coords:
            idx = []
            for entry in self.spec:
                i = 0
                for a in _axes_of(entry):
                    k = names.index(a)
                    i = i * sizes[k] + coord[k]
                idx.append(i)
            out[coord] = tuple(idx)
        return out

    def block_index(self, coord) -> Tuple[int, ...]:
        """The block (one index a dim) the device at mesh coordinate
        ``coord`` holds."""
        return self._index[tuple(coord)]

    def block_ranges(self, shape, index) -> List[Tuple[int, int]]:
        """``(start, stop)`` of each dim of block ``index`` of a leaf of
        ``shape``."""
        return [(i * (n // c), (i + 1) * (n // c))
                for i, n, c in zip(index, shape, self.counts)]

    def _table_axis(self) -> int:
        if self.seg_axis is not None:
            return self.seg_axis
        dims = [d for d, e in enumerate(self.spec) if e is not None]
        if len(dims) != 1:
            raise ValueError(f"{self.spec} shards {len(dims)} dims, not one")
        return dims[0]

    @property
    def mesh_axis(self) -> Optional[str]:
        """The mesh axis a table's segment axis shards over (None when it
        replicates)."""
        axes = _axes_of(self.spec[self._table_axis()])
        if len(axes) > 1:
            raise ValueError(f"a table's segment axis shards over one mesh "
                             f"axis, got {axes}")
        return axes[0] if axes else None

    @property
    def n_shards(self) -> int:
        return self.dim_blocks(self._table_axis())

    @property
    def devices(self) -> List[torch.device]:
        """Where a table's shards live, in shard order (the mesh's first
        device when it replicates)."""
        axis = self.mesh_axis
        if axis is None:
            return [self.mesh.devices.reshape(-1)[0]]
        return self.mesh.axis_devices(axis)


def logical_to_partition_spec(spec_axes: Sequence[Optional[str]],
                              shape: Sequence[int],
                              rules: ShardingRules) -> Tuple:
    """Each dim's logical axis resolved by ``rules`` (with the divisibility
    fallback); one mesh axis shards one dim only, so a later dim whose mesh
    axes an earlier dim took replicates."""
    parts, used = [], set()
    for ax, dim in zip(spec_axes, shape):
        resolved = rules.mesh_axes_for(ax, dim)
        flat = _axes_of(resolved)
        if any(a in used for a in flat):
            resolved = None
        used.update(flat)
        parts.append(resolved)
    return tuple(parts)


def _map_specs(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def shardings(specs, mesh, rules: Optional[ShardingRules] = None):
    """The placement of every leaf of a spec tree on ``mesh`` under
    ``rules`` (default :data:`DEFAULT_RULES`)."""
    rules = rules or ShardingRules.for_mesh(mesh)
    return _map_specs(lambda s: TablePlacement(
        mesh, logical_to_partition_spec(s.axes, s.shape, rules)), specs)


def shape_structs(specs, mesh=None, rules: Optional[ShardingRules] = None):
    """Meta tensors of each leaf's shape and dtype (nothing allocated),
    each carrying its placement as ``.sharding`` (None without a mesh)."""
    def one(s):
        t = torch.empty(s.shape, dtype=s.dtype, device="meta")
        t.sharding = None if mesh is None else TablePlacement(
            mesh, logical_to_partition_spec(s.axes, s.shape,
                                            rules or ShardingRules.for_mesh(
                                                mesh)))
        return t

    return _map_specs(one, specs)


def spec_bytes(specs) -> int:
    """The bytes a spec tree declares."""
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape) * torch.empty(
            (), dtype=specs.dtype).element_size()
    return sum(spec_bytes(v) for v in specs.values())


class Placed:
    """A parameter or cache leaf placed on a mesh: ``blocks[coord]`` is the
    contiguous block the device at mesh coordinate ``coord`` holds.
    Coordinates whose block and device agree share one tensor, so a leaf
    that replicates is held once per distinct device (four shards on one
    card hold one copy).  ``shape`` and ``dtype`` describe the whole leaf,
    which no device holds unless it replicates."""

    def __init__(self, placement: TablePlacement, shape, dtype,
                 blocks: Dict[Tuple[int, ...], torch.Tensor]):
        self.placement = placement
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks
        # layer views and gather orders, made once (a leaf's blocks are
        # written in place, never reassigned, once it serves)
        self._memo: Dict[Tuple, Any] = {}

    @property
    def mesh(self):
        return self.placement.mesh

    @property
    def spec(self) -> Tuple:
        return self.placement.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    @property
    def device(self) -> torch.device:
        return self.blocks[(0,) * self.mesh.devices.ndim].device

    def __repr__(self):
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, {len(self.unique())} blocks)")

    @staticmethod
    def build(placement: TablePlacement, shape, dtype, fn) -> "Placed":
        """A leaf whose block ``i`` on device ``dev`` is ``fn(i, dev)``,
        called once for every distinct (block, device)."""
        holders: Dict[Tuple, List] = {}
        grid = placement.mesh.devices
        for c in placement.mesh.coords:
            key = (placement.block_index(c), torch.device(grid[c]))
            holders.setdefault(key, []).append(c)
        blocks = {}
        for key, cs in holders.items():
            with coords.at(cs):  # made at the coordinates holding it
                t = fn(*key)
            for c in cs:
                blocks[c] = t
        return Placed(placement, shape, dtype, blocks)

    def ranges(self, coord) -> List[Tuple[int, int]]:
        """``(start, stop)`` of each dim of the block at ``coord``."""
        return self.placement.block_ranges(
            self.shape, self.placement.block_index(coord))

    @staticmethod
    def place(t: torch.Tensor, placement: TablePlacement) -> "Placed":
        """The whole tensor ``t`` (any device, typically the host) cut by
        ``placement``, each block copied to its device."""
        counts = [placement.dim_blocks(d) for d in range(t.dim())]
        for d, n in enumerate(counts):
            if t.shape[d] % n:
                raise ValueError(f"{n} blocks do not divide dim {d} of "
                                 f"{tuple(t.shape)}")

        def cut(index, dev):
            v = t
            for d, (i, n) in enumerate(zip(index, counts)):
                if n > 1:
                    size = t.shape[d] // n
                    v = v.narrow(d, i * size, size)
            # a view would keep the whole of t alive: blocks are copies
            return (v.to(dev, copy=True) if v.numel() < t.numel()
                    else v.to(dev)).contiguous()

        return Placed.build(placement, t.shape, t.dtype, cut)

    def local(self, coord) -> torch.Tensor:
        return self.blocks[tuple(coord)]

    def unique(self) -> List[Tuple[Tuple[int, ...], torch.Tensor]]:
        """``(first coordinate, tensor)`` of every distinct block tensor."""
        seen, out = set(), []
        for c, t in self.blocks.items():
            if id(t) not in seen:
                seen.add(id(t))
                out.append((c, t))
        return out

    def holders(self) -> List[Tuple[torch.Tensor, frozenset]]:
        """Every distinct block tensor with the coordinates holding it."""
        by_id: Dict[int, Tuple[torch.Tensor, List]] = {}
        for c, t in self.blocks.items():
            by_id.setdefault(id(t), (t, []))[1].append(c)
        return [(t, frozenset(cs)) for t, cs in by_id.values()]

    def each(self):
        """:meth:`unique`'s pairs, the caller's loop body for each run at
        the coordinates holding the block (``nn.coords.at``)."""
        for t, cs in self.holders():
            with coords.at(cs):
                yield min(cs), t

    def join(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (default the mesh's first), joined
        from one block of each index."""
        dev = torch.device(device) if device is not None else \
            torch.device(self.mesh.devices.reshape(-1)[0])
        with coords.kind("all-gather"):
            out = torch.empty(self.shape, dtype=self.dtype, device=dev)
            done = set()
            for c, t in self.blocks.items():
                i = self.placement.block_index(c)
                if i in done:
                    continue
                done.add(i)
                out[tuple(slice(a, b) for a, b in
                          self.placement.block_ranges(self.shape, i))] = \
                    t.to(dev)
        return out

    def gather(self, coord, axes: Sequence[str], dtype=None) -> torch.Tensor:
        """The block at ``coord`` joined, on its device, over the mesh axes
        ``axes`` (the FSDP all-gather: the dim those axes cut is made whole
        again; other dims stay ``coord``'s block).  With ``dtype`` each
        block is cast on its own device before it moves (the join moves
        ``dtype`` bytes)."""
        coord = tuple(coord)
        key = ("gather", coord, tuple(axes))
        if key not in self._memo:
            self._memo[key] = self._gather_order(coord, axes)
        d, parts = self._memo[key]
        if d is None:
            t = self.blocks[coord]
            if dtype is None:
                return t
            with coords.at((coord,)):
                return t.to(dtype)
        dev = self.mesh.devices[coord]
        # the join's moves recorded from the coordinates (an all-gather),
        # the blocks copied quietly
        blocks = []
        with coords.quiet():
            for c in parts:
                b = self.blocks[c]
                if dtype is not None:
                    with coords.at((c,)):
                        b = b.to(dtype)
                blocks.append(b.to(dev))
            with coords.forced((coord,)):
                out = torch.cat(blocks, d)
        coords.record("all-gather", [(c, coord, b.numel() * b.element_size())
                                     for c, b in zip(parts, blocks)], out)
        return out

    def _gather_order(self, coord, axes):
        """The dim the FSDP join concatenates and the coordinates of its
        blocks in order (``(None, None)``: nothing to join)."""
        names = self.mesh.axis_names
        axes = tuple(a for a in axes if a in names)
        dims = [d for d, e in enumerate(self.spec)
                if set(_axes_of(e)) & set(axes)]
        if not dims:
            return None, None
        if len(dims) > 1 or not set(_axes_of(self.spec[dims[0]])) <= \
                set(axes):
            raise ValueError(f"cannot gather {self.spec} over {axes}")
        d = dims[0]
        variants = {}
        for sub in np.ndindex(*(self.mesh.shape[a] for a in axes)):
            c = list(coord)
            for a, i in zip(axes, sub):
                c[names.index(a)] = int(i)
            variants[self.placement.block_index(c)[d]] = tuple(c)
        return d, [variants[i] for i in sorted(variants)]

    def clone(self) -> "Placed":
        """A copy of every distinct block, the sharing kept."""
        made = {}
        blocks = {}
        for c, t in self.blocks.items():
            if id(t) not in made:
                made[id(t)] = t.clone()
            blocks[c] = made[id(t)]
        return Placed(self.placement, self.shape, self.dtype, blocks)

    def map(self, fn, *others: "Placed") -> "Placed":
        """A leaf of this placement whose block at each coordinate is
        ``fn(block, *(o's block there for o in others))``, called once a
        distinct block tensor of this leaf (the sharing kept); ``others``
        are leaves on the same mesh whose block at a coordinate goes with
        this leaf's there (the same placement, or an int8 moment's row
        scales).  ``fn`` may change the dtype."""
        made, blocks = {}, {}
        for t, cs in self.holders():
            c = min(cs)
            with coords.at(cs):  # run at the coordinates holding it
                made[id(t)] = fn(t, *(o.blocks[c] for o in others))
        for c, t in self.blocks.items():
            blocks[c] = made[id(t)]
        dtype = next(iter(made.values())).dtype
        return Placed(self.placement, self.shape, dtype, blocks)

    def replace(self, placement: TablePlacement) -> "Placed":
        """This leaf re-cut by ``placement`` (another partition spec on the
        same mesh): each new block is copied, on its device, from the
        blocks of this leaf that overlap it, one distinct block index of
        this leaf at a time; the whole leaf is never assembled.  Returns
        ``self`` when the placement is the same."""
        if placement.spec == self.spec:
            return self
        src = {}
        for c, t in self.unique():
            src.setdefault(self.placement.block_index(c), (c, t))

        def block(index, dev):
            want = placement.block_ranges(self.shape, index)
            out = torch.empty([b - a for a, b in want], dtype=self.dtype,
                              device=dev)
            for i, (c, t) in src.items():
                have = self.placement.block_ranges(self.shape, i)
                lo = [max(a, x) for (a, _), (x, _) in zip(want, have)]
                hi = [min(b, y) for (_, b), (_, y) in zip(want, have)]
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                dst = tuple(slice(l - a, h - a)
                            for l, h, (a, _) in zip(lo, hi, want))
                sl = tuple(slice(l - x, h - x)
                           for l, h, (x, _) in zip(lo, hi, have))
                out[dst] = t[sl].to(dev)
            return out

        return Placed.build(placement, self.shape, self.dtype, block)

    def fill_index_(self, dim: int, index: int, value=0) -> "Placed":
        """Write ``value`` into index ``index`` of dim ``dim``, in place, in
        the blocks that hold it."""
        for c, t in self.unique():
            a, b = self.ranges(c)[dim]
            if a <= index < b:
                t.narrow(dim, index - a, 1).fill_(value)
        return self

    def select(self, dim: int, index: int) -> "Placed":
        """Index ``index`` of a replicated dim (a stack's layer): views of
        every block, the sharing kept."""
        key = ("select", dim, index)
        if key in self._memo:
            return self._memo[key]
        if self.spec[dim] is not None:
            raise ValueError(f"dim {dim} of {self.spec} is sharded")
        spec = self.spec[:dim] + self.spec[dim + 1:]
        views = {}
        blocks = {}
        for c, t in self.blocks.items():
            if id(t) not in views:
                views[id(t)] = t.select(dim, index)
            blocks[c] = views[id(t)]
        shape = self.shape[:dim] + self.shape[dim + 1:]
        out = Placed(TablePlacement(self.mesh, spec), shape, self.dtype,
                     blocks)
        self._memo[key] = out
        return out

    @staticmethod
    def stack(leaves: Sequence["Placed"], dim: int = 0) -> "Placed":
        """Leaves of one placement stacked on a new replicated dim ``dim``
        (each coordinate's blocks stacked; the sharing kept)."""
        first = leaves[0]
        spec = first.spec[:dim] + (None,) + first.spec[dim:]
        made, blocks = {}, {}
        for t, cs in first.holders():
            c = min(cs)
            with coords.at(cs):
                made[id(t)] = torch.stack([l.blocks[c] for l in leaves], dim)
        for c, t in first.blocks.items():
            blocks[c] = made[id(t)]
        shape = first.shape[:dim] + (len(leaves),) + first.shape[dim:]
        return Placed(TablePlacement(first.mesh, spec), shape, first.dtype,
                      blocks)

    def device_bytes(self) -> Dict[Tuple[int, ...], int]:
        """Bytes the device at each mesh coordinate holds of this leaf."""
        return {c: t.numel() * t.element_size()
                for c, t in self.blocks.items()}

    def expected_bytes(self) -> int:
        """Bytes a device holds under the partition spec."""
        n = self.numel() // math.prod(self.placement.dim_blocks(d)
                                      for d in range(self.ndim))
        return n * self.element_size()


def place(tree, placements):
    """A tree of whole tensors placed leaf by leaf (``shardings``' tree of
    placements beside it); a leaf that is not a tensor (a host int) stays
    as it is."""
    if isinstance(tree, dict):
        return {k: place(v, placements[k]) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return Placed.place(tree, placements)


def join(tree, device=None):
    """A placed tree joined leaf by leaf onto ``device`` (default each
    mesh's first device)."""
    if isinstance(tree, dict):
        return {k: join(v, device) for k, v in tree.items()}
    return tree.join(device) if isinstance(tree, Placed) else tree


def check_placed_bytes(tree, prefix: str = "") -> int:
    """Raise unless every placed leaf's every device holds exactly the
    bytes its partition spec gives; returns the number of leaves
    checked."""
    if isinstance(tree, dict):
        return sum(check_placed_bytes(v, f"{prefix}/{k}")
                   for k, v in tree.items())
    if not isinstance(tree, Placed):
        return 0
    want = tree.expected_bytes()
    for c, got in tree.device_bytes().items():
        if got != want:
            raise RuntimeError(
                f"{prefix}: the device at {c} holds {got} bytes, its "
                f"partition spec {tree.spec} gives {want}")
    return 1


def fallback_leaves(specs, mesh, rules: Optional[ShardingRules] = None,
                    prefix: str = "") -> List[str]:
    """The leaves of a spec tree that the divisibility fallback (or the
    one-dim-per-mesh-axis rule) replicates on ``mesh``: a dim whose logical
    axis has a rule naming a mesh axis of ``mesh`` (of size above 1) that
    stays unsharded.  Paths with the dim and its logical axis."""
    rules = rules or ShardingRules.for_mesh(mesh)
    if not isinstance(specs, ParamSpec):
        return [p for k, v in specs.items()
                for p in fallback_leaves(v, mesh, rules, f"{prefix}/{k}")]
    pspec = logical_to_partition_spec(specs.axes, specs.shape, rules)
    out = []
    for d, (ax, got) in enumerate(zip(specs.axes, pspec)):
        target = _axes_of(rules.rules.get(ax)) if ax is not None else ()
        live = [a for a in target if rules.mesh_axis_sizes.get(a, 1) > 1]
        if live and got is None:
            out.append(f"{prefix}[{d}:{ax}]")
    return out


def device_bytes(tree) -> Dict[Tuple[int, ...], int]:
    """Bytes each mesh coordinate holds of a placed tree."""
    out: Dict[Tuple[int, ...], int] = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Placed):
            for c, b in leaf.device_bytes().items():
                out[c] = out.get(c, 0) + b
    return out



def pcilt_table_sharding(mesh, G: int, ndim: int = 3,
                         rules: Optional[ShardingRules] = None,
                         mesh_axis: Optional[str] = None,
                         seg_axis: int = 0) -> TablePlacement:
    """The placement of a table operand on ``mesh`` (its segment axis
    sharded; the reference's ``NamedSharding``)."""
    rules = rules or ShardingRules.for_mesh(mesh)
    spec = pcilt_table_pspec(G, ndim, rules, mesh_axis, seg_axis)
    if isinstance(spec[seg_axis], tuple):
        raise ValueError(f"a table's segment axis shards over one mesh "
                         f"axis, got {spec[seg_axis]}")
    return TablePlacement(mesh, spec, seg_axis)


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
