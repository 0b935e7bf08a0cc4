"""Seeded fault injection, the chaos harness behind the serving resilience
layer (port of ``repro.runtime.faults``).

One :class:`FaultInjector` covers every fault class the engine must
survive:

* **scheduled step faults**: :meth:`FaultInjector.maybe_fail` raises at
  given steps, once each;
* **table corruption**: :meth:`corrupt_table` flips entries of a table
  tensor (conv ``[L, C, V]``, stacked projections ``[L, G, V, O]``,
  shared pools ``[X, V, O]``; one shard of tables sharded over a mesh), as
  a bit-flip in memory would;
* **pointer corruption**: :meth:`flip_seg_idx` re-aims extension-3
  ``seg_idx`` pointers at wrong (possibly out-of-range) pool rows;
* **activation poisoning**: :meth:`poison` plants NaN/Inf in activations
  or recurrent state;
* **calibration drift**: :meth:`drift_scale` multiplies rows of a
  parameter, moving the activations off their calibrated range without
  changing a table byte;
* **file garbling**: :meth:`garble_file` truncates or overwrites a file.

Every injection is recorded in :attr:`FaultInjector.events` (the same
dicts as the reference's) and logged.  With the same seed the injector
makes the same ``np.random.default_rng(seed)`` draws in the same order as
the reference's, so it picks the same sites.  Unlike the reference's,
:meth:`corrupt_table` flips the entries **in place** on the tensor's
device and returns the same tensor (a full-width projection stack is
14.5 GB: a copy would not fit beside it on the card); the other methods
return copies, since what they change is small.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("repro_torch.faults")

__all__ = ["FaultInjector"]


class FaultInjector:
    """Deterministic (seeded) fault schedule and corruption primitives."""

    def __init__(self, fail_at: Sequence[int] = (), seed: int = 0):
        self.fail_at = set(fail_at)
        self.rng = np.random.default_rng(seed)
        #: every injected fault, in injection order
        self.events: List[Dict[str, Any]] = []

    def _record(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})
        log.warning("injected %s: %s", kind, info)

    # -- scheduled step faults -----------------------------------------------

    def maybe_fail(self, step: int) -> None:
        """Raise at the scheduled steps, once each: replays are clean."""
        if step in self.fail_at:
            self.fail_at.discard(step)
            self._record("step_fault", step=int(step))
            raise RuntimeError(f"injected fault at step {step}")

    # -- table / pointer corruption ------------------------------------------

    def corrupt_table(self, tables, n_flips: int = 1):
        """Flip ``n_flips`` random entries of a contiguous table tensor in
        place and return it.  Each flipped value differs from the original
        (``x -> x + (1 + |x|)`` survives any float rounding).  Of a
        ``core.pcilt.ShardedTables`` one shard, drawn at random, is flipped
        in place on its device (the event names it)."""
        from repro_torch.core.pcilt import ShardedTables

        if isinstance(tables, ShardedTables):
            d = int(self.rng.integers(tables.n_shards))
            self.corrupt_table(tables.shards[d], n_flips)
            self.events[-1]["shard"] = d
            return tables
        if not tables.is_contiguous():
            raise ValueError("corrupt_table flips a contiguous tensor in place")
        flat = tables.view(-1)
        n = min(max(n_flips, 1), flat.numel())
        idx = self.rng.choice(flat.numel(), size=n, replace=False)
        at = torch.from_numpy(idx.astype(np.int64)).to(flat.device)
        old = flat[at].double().cpu().numpy()
        new = torch.tensor(old + (1.0 + np.abs(old)), dtype=torch.float64)
        flat[at] = new.to(flat.dtype).to(flat.device)
        sites = [tuple(int(c) for c in np.unravel_index(int(i), tables.shape))
                 for i in idx]
        self._record("table_corruption", shape=tuple(tables.shape),
                     sites=sites)
        return tables

    def flip_seg_idx(self, seg_idx: torch.Tensor, n_pool: Optional[int] = None,
                     n_flips: int = 1) -> torch.Tensor:
        """Re-aim ``n_flips`` extension-3 segment pointers; returns the
        corrupted copy.  Pointers move to another row of the ``n_pool``-row
        pool (a one-row pool gets an out-of-range pointer)."""
        a = seg_idx.detach().cpu().numpy().copy()
        X = int(n_pool) if n_pool is not None else int(a.max()) + 1
        n = min(max(n_flips, 1), a.size)
        idx = self.rng.choice(a.size, size=n, replace=False)
        for i in idx:
            old = int(a.reshape(-1)[i])
            if X > 1:
                new = (old + 1 + int(self.rng.integers(0, X - 1))) % X
            else:
                new = old + 1  # out of range: still a detectable wrong pointer
            a.reshape(-1)[i] = new
        self._record("seg_idx_flip", sites=[int(i) for i in idx], n_pool=X)
        return torch.from_numpy(a).to(seg_idx.device)

    # -- activation / state poisoning ----------------------------------------

    def poison(self, x: torch.Tensor, kind: str = "nan",
               n: int = 1) -> torch.Tensor:
        """Plant ``n`` NaN (or Inf) values at random positions of a float
        tensor; returns the poisoned copy."""
        a = x.detach().clone().contiguous()
        flat = a.view(-1)
        n = min(max(n, 1), flat.numel())
        idx = self.rng.choice(flat.numel(), size=n, replace=False)
        flat[torch.from_numpy(idx.astype(np.int64)).to(flat.device)] = \
            float("nan") if kind == "nan" else float("inf")
        self._record("activation_poison", poison=kind,
                     sites=[int(i) for i in idx], shape=tuple(a.shape))
        return a

    # -- calibration drift ----------------------------------------------------

    def drift_scale(self, x: torch.Tensor, gamma: float,
                    rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``x`` (or just ``rows`` of its leading axis) times ``gamma``;
        returns the drifted copy.  No table byte changes, so only the
        saturation sentinel can catch it."""
        a = x.detach().clone()
        g = torch.tensor(gamma, dtype=a.dtype, device=a.device)
        if rows is None:
            a *= g
            sites = "all"
        else:
            sites = [int(r) for r in rows]
            a[sites] *= g
        self._record("calibration_drift", gamma=float(gamma), rows=sites,
                     shape=tuple(a.shape))
        return a

    # -- on-disk artifact garbling -------------------------------------------

    def garble_file(self, path: str, mode: str = "truncate") -> None:
        """Corrupt a file in place: ``"truncate"`` keeps the first half of
        its bytes, ``"garbage"`` overwrites them with non-JSON bytes,
        ``"empty"`` leaves none.  A missing file is recorded, not an
        error."""
        if not os.path.exists(path):
            self._record("file_garble", path=path, mode=mode, absent=True)
            return
        with open(path, "rb") as f:
            data = f.read()
        if mode == "truncate":
            data = data[: max(len(data) // 2, 1)]
        elif mode == "garbage":
            data = b'{"tiles": tru\x00\xff not json'
        elif mode == "empty":
            data = b""
        else:
            raise ValueError(f"unknown garble mode {mode!r}")
        with open(path, "wb") as f:
            f.write(data)
        self._record("file_garble", path=path, mode=mode, absent=False)
