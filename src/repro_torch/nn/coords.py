"""The coordinate scope and the move record of the single-process mesh.

The port's mesh (``launch.mesh``) is one process that runs every shard's
body in turn.  On a mesh of distinct devices a tensor's device says which
mesh coordinate holds it; on a mesh that repeats one device (the CPU tests,
a card's shards, or ``meta``, where the dry run lays out a production mesh
without allocating anything) every coordinate shares it, and a copy to "the
shard's device" does nothing.  This module keeps the coordinates instead:

* **The scope.** :func:`at` names the coordinates the code in its block
  runs at.  ``nn.layers.Ctx.at`` / ``Ctx.shards`` enter it wherever a
  shard's body runs, ``nn.layers.Rows.items`` at each row's first
  coordinate, ``Placed.build`` / ``Placed.map`` at the coordinates that
  hold the block being made.  Work outside any scope belongs to the
  tracker's default (the mesh's first coordinate).
* **The tags.** Under a :func:`tracking` block every tensor an operation
  makes is tagged with the coordinates it lives at: a view where its base
  lives; any other output at the scope, unless its inputs all live
  elsewhere: then at the coordinate of theirs nearest the scope (the
  operation runs where its inputs are, as it would on distinct devices).
  A backward operation runs where the forward operation it differentiates
  ran (by the autograd node's sequence number), unless it runs in a scope:
  a checkpointed forward recomputed in the backward pass enters its
  scopes again.  :func:`tag_inputs` tags
  the arguments of a step: each block of a placed leaf with the
  coordinates holding it, any other tensor with the default.
* **The record.** A ``Tensor.to(device)`` into a scope whose coordinates
  the tensor does not live at is a move from its coordinate to each of
  them, whether or not the devices differ: every open recorder
  (:func:`recording_moves`, ``launch.op_analysis``) gets its kind, source,
  destination, bytes and call site.  The sites that move a placed leaf's
  blocks (``Placed.gather``'s FSDP join, the train step's replica
  all-reduce, ``optim.compress``) record their moves from the coordinates
  themselves (:func:`record`).  The kinds are the reference's collective
  names (:data:`KINDS`: ``Ctx.reduce`` an ``all-reduce``, the FSDP and
  sequence joins ``all-gather``, ``row_parallel`` ``reduce-scatter``, the
  MoE dispatch ``all-to-all``, the pipeline's hand-off
  ``collective-permute``), set by :func:`kind` around a site, and
  ``broadcast`` for a fan-out with no reference counterpart (a row's
  activation sent to its model shards), the default.  When a moved
  tensor's gradient is taken, the gradient's move back is recorded under
  the reverse kind (:data:`REVERSE`).

Nothing here runs unless a recorder is open: outside :func:`tracking` a
scope is a push and a pop.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KINDS", "REVERSE", "at", "current", "near", "kind", "quiet",
           "forced",
           "record",
           "recording_moves", "tracking", "Tracker", "tag", "tag_inputs",
           "coords_of"]

#: the move kinds: the reference's five collectives and the port's
#: fan-out of a row's activation to its shards
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")

#: the kind of a move's gradient moving back
REVERSE = {"broadcast": "all-reduce", "all-reduce": "broadcast",
           "all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
           "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}

_SCOPE: List[Optional[frozenset]] = [None]
_KIND: List[str] = ["broadcast"]
_QUIET: List[int] = [0]
_FORCED: List[Optional[frozenset]] = [None]
_RECORDERS: List[Callable] = []
_TRACKERS: List["Tracker"] = []


class _Push:
    """A context manager pushing ``value`` on ``stack`` for its block."""

    __slots__ = ("stack", "value")

    def __init__(self, stack, value):
        self.stack, self.value = stack, value

    def __enter__(self):
        self.stack.append(self.value)

    def __exit__(self, *exc):
        # its own entry, even when a generator's scope (``Ctx.shards``)
        # closes late, after an exception left the loop
        st = self.stack
        for i in range(len(st) - 1, 0, -1):
            if st[i] is self.value:
                del st[i]
                return


def at(coords: Iterable) -> _Push:
    """The scope: the code in the block runs at the mesh coordinates
    ``coords`` (tuples)."""
    return _Push(_SCOPE, frozenset(coords))


def current() -> Optional[frozenset]:
    """The innermost scope's coordinates (None outside any)."""
    return _SCOPE[-1]


def kind(name: str) -> _Push:
    """The kind of the moves made in the block (``broadcast`` outside
    any)."""
    if name not in REVERSE:
        raise ValueError(f"unknown move kind {name!r}; known: {KINDS}")
    return _Push(_KIND, name)


def quiet() -> _Push:
    """No ``Tensor.to`` in the block is recorded: a site that records its
    own moves (:func:`record`) copies its blocks inside it."""
    return _Push(_QUIET, 1)


def coords_of(t) -> Optional[frozenset]:
    """The coordinates a tracked tensor lives at (None: untracked)."""
    return getattr(t, "_mesh_coords", None)


def _tag(t, coords):
    try:
        t._mesh_coords = coords
    except (AttributeError, RuntimeError):
        pass


def tag(t, coords: Iterable):
    """Say that ``t`` lives at ``coords`` from now on (a block made whole
    at every coordinate holding it by a reduction that records its own
    moves)."""
    _tag(t, frozenset(coords))


def _site(depth: int) -> str:
    f = sys._getframe(depth)
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}" \
        f"({f.f_code.co_name})"


def record(kind_: str, moves, out=None, *, site: Optional[str] = None,
           alias: bool = False):
    """Record moves of ``kind_``, each ``(src, dst, nbytes)`` between two
    coordinates (a pair with ``src == dst`` is no move), with every open
    recorder.  ``out`` is the tensor the moves made (its gradient's moves
    back are recorded, reversed, when one is taken); ``alias`` says it
    shares the source's storage (a move between coordinates of one
    device)."""
    if not _RECORDERS:
        return
    site = site or _site(2)
    es = [{"kind": kind_, "src": tuple(s), "dst": tuple(d),
           "bytes": int(n), "site": site} for s, d, n in moves if s != d]
    if not es:
        return
    for e in es:
        for r in list(_RECORDERS):
            r(e, out, alias)
    if out is not None and torch.is_tensor(out) and out.requires_grad:
        back = [{"kind": REVERSE[kind_], "src": e["dst"], "dst": e["src"],
                 "bytes": e["bytes"], "site": site + " (backward)"}
                for e in es]

        def hook(g):
            for e in back:
                for r in list(_RECORDERS):
                    r(dict(e), None, False)

        out.register_hook(hook)


def forced(coords: Iterable) -> _Push:
    """Every operation in the block runs at ``coords``, wherever its
    inputs live (a site that records its own moves does its arithmetic
    under it)."""
    return _Push(_FORCED, frozenset(coords))


def _pick(src: frozenset, dst) -> tuple:
    """The source coordinate of a move to ``dst`` from a tensor held at
    ``src``: the one that differs from ``dst`` at the fewest axes, the
    first in order among equals."""
    return min(src, key=lambda c: (sum(a != b for a, b in zip(c, dst)), c))


def near(t):
    """A scope for work on ``t``: the current one where ``t`` lives there
    (or is untracked), else ``t``'s coordinate nearest it (a time block
    of a KV cache attended where the block is)."""
    have = coords_of(t)
    cur = _SCOPE[-1] or (_TRACKERS[-1].default if _TRACKERS else None)
    if have is None or cur is None or cur <= have:
        return _Push(_SCOPE, cur)
    return _Push(_SCOPE, frozenset((_pick(have, min(cur)),)))


def _moves_device(args, kwargs) -> bool:
    if "device" in kwargs:
        return True
    return any(isinstance(a, (torch.device, str)) for a in args[1:])


_TENSOR_TO = torch._C.TensorBase.to


def _to_tracked(t, *args, **kwargs):
    """``Tensor.to`` under a tracker: a move into the scope.  It replaces
    the method for the tracker's life (a function mode would miss a
    checkpointed forward recomputed in the backward pass)."""
    if _QUIET[-1] or not _TRACKERS or not _moves_device((t,) + args,
                                                         kwargs):
        return _TENSOR_TO(t, *args, **kwargs)
    src = coords_of(t)
    dst = _SCOPE[-1] or _TRACKERS[-1].default
    if src is None or dst is None or dst <= src:
        return _TENSOR_TO(t, *args, **kwargs)
    _FORCED.append(dst)
    try:
        out = _TENSOR_TO(t, *args, **kwargs)
        alias = out is t
        if alias:  # one device: the moved tensor is a view at dst
            out = t.view(t.shape)
    finally:
        _FORCED.pop()
    _tag(out, dst)
    nbytes = t.numel() * t.element_size()
    record(_KIND[-1], [(_pick(src, c), c, nbytes) for c in sorted(dst - src)],
           out, site=_site(2), alias=alias)
    return out


_Tensor = torch.Tensor


def _tensors(xs, out: list):
    for x in xs:
        if isinstance(x, _Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


_META = torch.device("meta")
#: (operation, its arguments' signature) -> its outputs' (shape, stride,
#: dtype), for the operations on meta tensors whose outputs are fresh
_META_OUTS: Dict = {}


def _sig(x):
    """A hashable signature of an argument of an operation on meta
    tensors (raises TypeError where there is none)."""
    if isinstance(x, _Tensor):
        if x.device != _META:
            raise TypeError("not meta")
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    hash(x)
    return x


def _fresh_outputs(func) -> bool:
    if func.is_view:
        return False
    schema = func._schema
    return not schema.is_mutable and all(
        r.alias_info is None and str(r.type) in ("Tensor", "Tensor[]")
        for r in schema.returns)


_FRESH: Dict = {}


def _run(func, args, kwargs, ins):
    """``func(*args, **kwargs)``; on meta tensors an operation whose
    outputs are fresh tensors runs its meta kernel once a signature, and
    then only makes outputs of the shapes, strides and dtypes it gave (a
    meta kernel checks and infers shapes; many run in Python)."""
    fresh = _FRESH.get(func)
    if fresh is None:
        fresh = _FRESH[func] = _fresh_outputs(func)
    if not fresh or (not ins and kwargs.get("device") != _META):
        return func(*args, **kwargs)
    try:
        key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
    except TypeError:
        return func(*args, **kwargs)
    hit = _META_OUTS.get(key)
    if hit is None:
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, _Tensor) else out
        if not isinstance(outs, (list, tuple)) or not all(
                isinstance(o, _Tensor) for o in outs):
            return out
        held = {t.untyped_storage()._cdata for t in ins}
        if any(o.untyped_storage()._cdata in held for o in outs):
            _FRESH[func] = False  # a view its schema does not declare
            return out
        _META_OUTS[key] = (isinstance(out, _Tensor), type(out), [
            (tuple(o.shape), o.stride(), o.dtype) for o in outs])
        return out
    single, kind_, metas = hit
    made = [torch.empty_strided(sh, st, dtype=dt, device=_META)
            for sh, st, dt in metas]
    return made[0] if single else kind_(made)


class Tracker(TorchDispatchMode):
    """Tags every tensor an operation makes with its coordinates (module
    docstring).  Subclasses count what each operation does at them
    (:meth:`on_op`).  ``default``: the coordinates of work outside any
    scope (a frozenset, or None: untagged)."""

    def __init__(self, default: Optional[frozenset] = None):
        super().__init__()
        self.default = default
        self.node_coords: Dict[int, frozenset] = {}
        self.seq_seen = torch._C._autograd._get_sequence_nr()
        self.crossed = 0  # ops whose inputs live apart, no move between

    def place(self, ins) -> Optional[frozenset]:
        """Where an operation on ``ins`` runs (module docstring)."""
        forced = _FORCED[-1]
        if forced is not None:
            return forced
        scope = _SCOPE[-1] or self.default
        common = None
        for t in ins:
            c = getattr(t, "_mesh_coords", None)
            if c is not None and c is not common:
                common = c if common is None else common & c
        if common is None or (scope is not None and scope <= common):
            return scope
        if common:
            if scope is None:
                return common
            return frozenset((_pick(common, min(scope)),))
        self.crossed += 1
        return scope

    def on_op(self, func, ins, outs, coords):
        """Called after every operation with its tensor inputs and
        outputs and the coordinates it ran at."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        node = torch._C._current_autograd_node()
        if node is not None and _SCOPE[-1] is None and _FORCED[-1] is None:
            coords = self.node_coords.get(node._sequence_nr(), self.default)
        else:  # a forward, or one recomputed in a backward under its scopes
            coords = self.place(ins)
        seq = torch._C._autograd._get_sequence_nr()
        if seq > self.seq_seen:  # the nodes made since: run here
            for s in range(self.seq_seen, seq):
                self.node_coords[s] = coords
            self.seq_seen = seq
        self.before_op(func, ins, coords)
        out = _run(func, args, kwargs, ins)
        outs = [out] if isinstance(out, _Tensor) else \
            _tensors(out, []) if isinstance(out, (list, tuple)) else []
        base = getattr(ins[0], "_mesh_coords", None) if func.is_view and \
            ins and _FORCED[-1] is None else None
        for o in outs:
            if not any(o is i for i in ins):
                _tag(o, base if base is not None else coords)
        self.on_op(func, ins, outs, coords)
        return out

    def before_op(self, func, ins, coords):
        """Called before every operation (a subclass may refuse it)."""


# the dispatch mode runs eagerly, never under torch.compile: skip the
# wrapper that keeps dynamo out of it (a call an operation)
_RAW = Tracker.__dict__["__torch_dispatch__"]
Tracker.__torch_dispatch__ = getattr(_RAW, "__wrapped__", _RAW)


class tracking:
    """Tag tensors and record moves in the block (module docstring); the
    active tracker when one is open, else a new :class:`Tracker` with
    ``default``.  ``tracker`` installs a given one."""

    def __init__(self, default: Optional[frozenset] = None,
                 tracker: Optional[Tracker] = None):
        self.tracker = tracker
        self.default = default
        self.opened = False

    def __enter__(self) -> Tracker:
        if self.tracker is None and _TRACKERS:
            self.tracker = _TRACKERS[-1]
            return self.tracker
        if self.tracker is None:
            self.tracker = Tracker(self.default)
        self.tracker.__enter__()
        if not _TRACKERS:
            torch.Tensor.to = _to_tracked
        _TRACKERS.append(self.tracker)
        self.opened = True
        return self.tracker

    def __exit__(self, *exc):
        if self.opened:
            _TRACKERS.pop()
            if not _TRACKERS:
                del torch.Tensor.to  # TensorBase's again
            self.tracker.__exit__(*exc)


class recording_moves:
    """Within the block every move (module docstring) appends ``{"kind",
    "src", "dst", "bytes", "site"}`` to the yielded list, under the active
    tracker or a new one whose default is ``default`` (``at`` a mesh's
    first coordinate, say)."""

    def __init__(self, default: Optional[Iterable] = None):
        self.default = None if default is None else frozenset(default)

    def __enter__(self) -> list:
        self.log: list = []
        self._rec = lambda e, out, alias: self.log.append(e)
        _RECORDERS.append(self._rec)
        self._track = tracking(self.default)
        self._track.__enter__()
        return self.log

    def __exit__(self, *exc):
        self._track.__exit__(*exc)
        _RECORDERS.remove(self._rec)


def tag_inputs(tree, default: frozenset):
    """Tag a step's arguments: each distinct block of a placed leaf (and
    of its memoized layer views) with the coordinates holding it, any other
    tensor with ``default``."""
    from .module import Placed

    if isinstance(tree, dict):
        for v in tree.values():
            tag_inputs(v, default)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tag_inputs(v, default)
    elif isinstance(tree, Placed):
        for t, holders in tree.holders():
            _tag(t, holders)
        for v in tree._memo.values():
            if isinstance(v, Placed):
                tag_inputs(v, default)
    elif torch.is_tensor(tree):
        _tag(tree, default)
