"""Checkpointing on the reference's on-disk layout (port of
``repro.checkpoint.checkpoint``).

One directory per step, renamed into place when complete:

    <root>/step_00000100.tmp/ -> <root>/step_00000100/
        manifest.json       # leaf names, shapes, dtypes, sha256 of the npz
        shard_p0.npz        # the arrays, a0 ... aN in leaf order

Leaves are named and ordered as ``jax.tree_util.tree_flatten_with_path``
names and orders them (dict keys sorted at every level, names joined with
``/``), so a checkpoint written by either package restores in the other.
A restore places the arrays on a named device, in the structure of the tree
it is given, or, given ``shardings`` (a matching tree of
``nn.module.TablePlacement``), each leaf by its placement on the current
mesh (the elastic re-mesh path).  A placed tree is saved as its joined
leaves, so either package reads it.

``Checkpointer.save_async`` copies every leaf to host memory before its
write thread starts (a later step may then change the tensors), and
``restore_latest`` first joins a pending write, so it never reads a
directory list that a write in flight is about to change.  A failure
mid-write leaves the previous checkpoint as it was (tmp dir + rename).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import resolve_device, to_numpy, to_torch

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer"]

_MANIFEST = "manifest.json"
_READ_CHUNK = 64 << 20


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, values: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[name]``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return values[prefix[:-1]]


def _host(x) -> np.ndarray:
    """A leaf as a host array that owns its memory (a placed leaf joined
    on the host)."""
    from repro_torch.nn.module import Placed

    if isinstance(x, Placed):
        return to_numpy(x.join("cpu"))
    if torch.is_tensor(x):
        a = to_numpy(x)
        # a CPU tensor's numpy view shares its storage
        return a.copy() if x.device.type == "cpu" else a
    return np.array(x)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_READ_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _write(root: str, step: int, names: List[str], host: List[np.ndarray],
           extra: Optional[Dict[str, Any]]) -> str:
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    npz_path = os.path.join(tmp, "shard_p0.npz")
    np.savez(npz_path, **{f"a{i}": a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "names": names,
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
        "sha256": _sha256(npz_path),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(root: str, step: int, tree, extra: Optional[Dict[str, Any]] = None):
    """Synchronous checkpoint write with atomic rename; returns its dir."""
    flat = _flatten(tree)
    return _write(root, step, [n for n, _ in flat],
                  [_host(x) for _, x in flat], extra)


def save_async(root: str, step: int, tree,
               extra: Optional[Dict[str, Any]] = None,
               then=None) -> threading.Thread:
    """Snapshot ``tree`` to host memory now, then write it (and call
    ``then()``) on a thread, which is started and returned: join it to
    fence."""
    flat = _flatten(tree)
    names, host = [n for n, _ in flat], [_host(x) for _, x in flat]

    def _run():
        _write(root, step, names, host, extra)
        if then is not None:
            then()

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return t


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(root: str, step: int, like_tree, shardings=None, *,
            verify: bool = True, device="cuda"):
    """Load a checkpoint into the structure of ``like_tree`` on ``device``,
    or with ``shardings`` (a tree of ``nn.module.TablePlacement`` matching
    ``like_tree``: the current mesh's) each leaf placed by its placement,
    each block copied to its device from the host (a None placement: the
    leaf whole on ``device``).  Returns ``(tree,
    extra)``; raises on a sha256 mismatch (with ``verify``) or when the
    leaf names differ."""
    from repro_torch.nn.module import Placed

    dev = None
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    npz_path = os.path.join(d, "shard_p0.npz")
    if verify and _sha256(npz_path) != manifest["sha256"]:
        raise IOError(f"checkpoint {d} corrupt: sha mismatch")
    names = [n for n, _ in _flatten(like_tree)]
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint tree mismatch:\n saved: %s...\n want: %s..."
            % (manifest["names"][:4], names[:4]))
    places = dict(_flatten(shardings)) if shardings is not None else {}
    if places and sorted(places) != sorted(names):
        raise ValueError("shardings do not match the tree's leaves")
    if any(places.get(n) is None for n in names):
        dev = resolve_device(device)
    with np.load(npz_path) as data:
        values = {n: to_torch(data[f"a{i}"], dev) if places.get(n) is None
                  else Placed.place(to_torch(data[f"a{i}"]), places[n])
                  for i, n in enumerate(names)}
    return _unflatten(like_tree, values), manifest["extra"]


class Checkpointer:
    """Async writes with retention of the ``keep`` newest steps."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra=None):
        self.wait()
        self._thread = save_async(self.root, step, tree, extra, then=self._gc)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, shardings=None, *, device="cuda"):
        """``(step, tree, extra)`` of the newest checkpoint (placed by
        ``shardings`` when given), after any pending write has finished;
        ``(None, None, None)`` when there is none."""
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None, None
        tree, extra = restore(self.root, step, like_tree, shardings,
                              device=device)
        return step, tree, extra
