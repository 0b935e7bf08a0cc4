"""Per-coordinate operation analysis of a step (the counterpart of the
reference's ``src/repro/launch/hlo_analysis.py``).

The reference lowers a step to HLO, compiles it and walks the text: a
``while`` body counted once a trip, dot flops ``2·|out|·|contraction|``,
each collective's largest buffer, and an HBM-traffic proxy.  Eager PyTorch
has no HLO and no trip count: every layer runs, so every operation is
seen.  :class:`analysis` counts them as they run, under the mesh's
coordinate tracker (``nn.coords``), one count a mesh coordinate, on any
tensors: ``meta`` ones (the dry run, ``launch.dryrun``: nothing allocated)
or real ones (the same step on the CPU or a card, to hold the dry run to).

* ``flops``: matmuls and convolutions, ``2·|out|·|contraction|`` (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``; a convolution
  ``2·|out|·|weight| / C_out``), forward and backward, at the coordinates
  the operation ran at.
* ``coll``, ``collective_bytes``, ``top_collectives``: the move record
  (``nn.coords``) by kind: each coordinate's moves and the bytes that
  cross its links, sent plus received; the top moves by kind and call
  site.
* ``bytes_traffic_est``: the bytes every operation that is not a view
  reads and writes (Σ input + output bytes).  Not the reference's proxy,
  which counts only the operations that would not fuse on a TPU: eager
  PyTorch fuses nothing, so every operation's operands cross the memory.
* ``top_buffers``: the largest outputs, each with its operation and
  coordinates.
* ``peak_live_bytes``: each coordinate's most bytes of operation outputs
  alive at once (a new storage counted at the coordinates of the
  operation that made it, until the last tensor viewing it is freed; a
  move between coordinates that share a device adds the moved bytes at
  the destination for the moved tensor's life): the counterpart of
  ``memory_analysis()``'s temp bytes.  The arguments are not in it.

A step that reads a meta tensor's value back to the host cannot run in a
dry run: the analysis raises :class:`HostReadError` naming the operation
and the line.

The report's per-device numbers are the busiest coordinate's, each key
its own (``report()["busiest"]`` names it); ``per_coord`` holds them
all.
"""

from __future__ import annotations

import heapq
import math
import os
import sys
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch

from repro_torch.nn import coords

__all__ = ["analysis", "OpCounter", "HostReadError", "op_flops"]

aten = torch.ops.aten

#: operations that read a tensor's value back to the host
_HOST_READS = {aten._local_scalar_dense.default, aten.nonzero.default,
               aten.is_nonzero.default, aten.equal.default}


#: wrappers that make no tensor (``torch.tensor(list)`` on the CPU)
_NOT_OPS = {aten.lift_fresh.default, aten.lift_fresh_copy.default}


class HostReadError(RuntimeError):
    """A step read a meta tensor's value back to the host."""


def _numel(t) -> int:
    return math.prod(t.shape)


def _conv_flops(out, w) -> int:
    return 2 * _numel(out) * _numel(w) // max(int(w.shape[0]), 1)


def _mm(ins, outs):
    a, b = ins[-2], ins[-1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(ins, outs):
    a, b = ins[-2], ins[-1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_backward(ins, outs):
    # grad_input and grad_weight, each a forward's worth
    return sum(_conv_flops(ins[0], ins[2]) for o in outs[:2]
               if o is not None)


_FLOPS = {aten.mm: _mm, aten.addmm: _mm, aten.bmm: _bmm, aten.baddbmm: _bmm,
          aten.mv: lambda ins, outs: 2 * _numel(ins[0]),
          aten.dot: lambda ins, outs: 2 * _numel(ins[0]),
          aten.convolution: lambda ins, outs: _conv_flops(outs[0], ins[1]),
          aten.convolution_backward: _conv_backward}


def op_flops(func, ins, outs) -> int:
    """The matmul / convolution flops of one operation (0 for others)."""
    fn = _FLOPS.get(func.overloadpacket)
    return int(fn(ins, outs)) if fn is not None else 0


def _nbytes(t) -> int:
    return t.nbytes


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _user_site() -> str:
    """The first frame outside torch and this module: the line that read
    the value."""
    f = sys._getframe(1)
    here = os.path.dirname(os.path.dirname(__file__))
    while f is not None:
        name = f.f_code.co_filename
        if "torch" + os.sep not in name or here in name:
            if not name.endswith(("op_analysis.py", "coords.py")):
                return f"{name}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "unknown"


def _key(c) -> str:
    return ",".join(str(i) for i in c) if c else "-"


class OpCounter(coords.Tracker):
    """The tracker that counts (module docstring)."""

    def __init__(self, default: Optional[frozenset] = None,
                 top_k: int = 25):
        super().__init__(default)
        self.top_k = top_k
        self.flops: Dict[tuple, int] = defaultdict(int)
        self.traffic: Dict[tuple, int] = defaultdict(int)
        self.live: Dict[tuple, int] = defaultdict(int)
        self.peak: Dict[tuple, int] = defaultdict(int)
        self.coll: Dict[tuple, Dict] = defaultdict(
            lambda: {k: {"count": 0, "bytes": 0} for k in coords.KINDS})
        self.by_site: Dict[tuple, Dict] = defaultdict(lambda: defaultdict(int))
        self.moves = 0
        self.n_ops = 0
        self.buffers: list = []
        self._storages: Dict[int, list] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._open = True

    def _on_death(self, t, fn, *a):
        """``fn(*a)`` once ``t`` is freed (a weak reference's callback,
        lighter than ``weakref.finalize``)."""
        def cb(r):
            self._refs.pop(id(r), None)
            fn(*a)

        r = weakref.ref(t, cb)
        self._refs[id(r)] = r

    # -- the record's recorder ----------------------------------------------
    def on_move(self, e, out, alias):
        if not self._open:
            return
        self.moves += 1
        for c in (e["src"], e["dst"]):
            k = self.coll[c][e["kind"]]
            k["count"] += 1
            k["bytes"] += e["bytes"]
            self.by_site[c][(e["kind"], e["site"])] += e["bytes"]
        if alias and out is not None:  # the moved bytes held at dst
            self._alloc((e["dst"],), e["bytes"])
            self._on_death(out, self._free, (e["dst"],), e["bytes"])

    # -- live bytes ----------------------------------------------------------
    def _alloc(self, cs, n):
        for c in cs:
            v = self.live[c] + n
            self.live[c] = v
            if v > self.peak[c]:
                self.peak[c] = v

    def _free(self, cs, n):
        if self._open:
            for c in cs:
                self.live[c] -= n

    def _unref(self, key):
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[2] -= 1
        if rec[2] == 0:
            del self._storages[key]
            self._free(rec[0], rec[1])

    # -- the operations ------------------------------------------------------
    def before_op(self, func, ins, coords_):
        if func in _HOST_READS and any(t.device.type == "meta" for t in ins):
            raise HostReadError(
                f"the step reads a meta tensor's value back to the host "
                f"({func}) at {_user_site()}: a dry run needs a step that "
                f"keeps its values on the device")

    def on_op(self, func, ins, outs, coords_):
        if coords_ is None or func in _NOT_OPS:
            return
        self.n_ops += 1
        f = op_flops(func, ins, outs)
        if f:
            for c in coords_:
                self.flops[c] += f
        if not func.is_view:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            for c in coords_:
                self.traffic[c] += b
        in_keys = None
        for o in outs:
            if any(o is i for i in ins):
                continue
            key = _storage_key(o)
            if key is None:
                continue
            rec = self._storages.get(key)
            if rec is not None:  # a view of a counted storage
                rec[2] += 1
                self._on_death(o, self._unref, key)
                continue
            if in_keys is None:
                in_keys = {_storage_key(t) for t in ins}
            if func.is_view or key in in_keys:
                continue  # a view of an argument
            n = o.untyped_storage().nbytes()
            self._storages[key] = [coords_, n, 1]
            self._alloc(coords_, n)
            self._on_death(o, self._unref, key)
            item = (n, self.n_ops, str(func.overloadpacket.__name__),
                    tuple(sorted(coords_)))
            if len(self.buffers) < self.top_k:
                heapq.heappush(self.buffers, item)
            elif n > self.buffers[0][0]:
                heapq.heapreplace(self.buffers, item)

    # -- the report ----------------------------------------------------------
    def per_coord(self) -> Dict[tuple, Dict]:
        cs = set(self.flops) | set(self.traffic) | set(self.peak) \
            | set(self.coll)
        out = {}
        for c in sorted(cs):
            coll = {k: dict(v) for k, v in self.coll[c].items()} \
                if c in self.coll else \
                {k: {"count": 0, "bytes": 0} for k in coords.KINDS}
            out[c] = {"flops": self.flops.get(c, 0),
                      "bytes_traffic_est": self.traffic.get(c, 0),
                      "peak_live_bytes": self.peak.get(c, 0),
                      "coll": coll,
                      "collective_bytes": sum(v["bytes"]
                                              for v in coll.values())}
        return out

    def report(self) -> Dict:
        """``analyze_hlo``'s keys for the busiest coordinate (each key its
        own), ``busiest`` naming it, ``per_coord`` (keyed ``"i,j"``), the
        number of operations and moves seen, and ``crossed``: operations
        whose inputs lived at different coordinates with no move between
        (0 when every per-shard body runs in its scope)."""
        per = self.per_coord()
        zero = {"flops": 0, "bytes_traffic_est": 0, "peak_live_bytes": 0,
                "coll": {k: {"count": 0, "bytes": 0} for k in coords.KINDS},
                "collective_bytes": 0}
        busiest = {}
        for key in ("flops", "bytes_traffic_est", "peak_live_bytes",
                    "collective_bytes"):
            c = max(per, key=lambda c: (per[c][key], [-i for i in c])) \
                if per else None
            busiest[key] = c
        cc = busiest["collective_bytes"]
        top = sorted(((b, k, s) for (k, s), b in self.by_site[cc].items()),
                     reverse=True)[:self.top_k] if cc is not None else []
        pick = {k: (per[c] if c is not None else zero)
                for k, c in busiest.items()}
        return {
            "flops": pick["flops"]["flops"],
            "bytes_traffic_est": pick["bytes_traffic_est"][
                "bytes_traffic_est"],
            "peak_live_bytes": pick["peak_live_bytes"]["peak_live_bytes"],
            "coll": pick["collective_bytes"]["coll"],
            "collective_bytes": pick["collective_bytes"]["collective_bytes"],
            "top_collectives": [{"kind": k, "bytes": b, "op": s}
                                for b, k, s in top],
            "top_buffers": [{"bytes": n, "op": op,
                             "coords": [_key(c) for c in cs]}
                            for n, _, op, cs in sorted(self.buffers,
                                                       reverse=True)],
            "busiest": {k: None if c is None else _key(c)
                        for k, c in busiest.items()},
            "per_coord": {_key(c): v for c, v in per.items()},
            "n_ops": self.n_ops,
            "n_moves": self.moves,
            "crossed": self.crossed,
        }


class analysis:
    """Count every operation and move in the block (module docstring);
    yields the :class:`OpCounter` (``.report()``).  ``mesh``: the mesh of
    the step (its first coordinate is the default; None: one device, the
    coordinate ``()``).  ``args``: the step's arguments, tagged with the
    coordinates holding them (``nn.coords.tag_inputs``)."""

    def __init__(self, mesh=None, args=None, top_k: int = 25):
        first = mesh.coords[0] if mesh is not None else ()
        self.default = frozenset((first,))
        self.args = args
        self.top_k = top_k

    def __enter__(self) -> OpCounter:
        self.counter = OpCounter(self.default, self.top_k)
        if self.args is not None:
            coords.tag_inputs(self.args, self.default)
        coords._RECORDERS.append(self.counter.on_move)
        self._track = coords.tracking(tracker=self.counter)
        self._track.__enter__()
        return self.counter

    def __exit__(self, *exc):
        self._track.__exit__(*exc)
        coords._RECORDERS.remove(self.counter.on_move)
        self.counter._open = False
