"""Persistent design cache for the PCILT CUDA kernels (port of
``repro.kernels.autotune``).

The reference's cache maps a problem shape to the Pallas tiling that wins
it.  The CUDA kernels take no tiling, but most come in two designs that
``kernels.ops`` can force with ``variant=`` (the fused GEMVs ``split`` /
``direct``, the fused dwconv ``tiled`` / ``direct``, the head GEMV
``split`` / ``direct``, the convs, the host-packed GEMV and conv and the
host-packed dwconv ``staged`` / ``direct``).  This cache maps a shape key
to the design that wins it: discovered once by timing the designs whose
shape guard admits the shape, then persisted, so that every later launch
on the same key is a dict hit with zero timing runs.

Cache format (JSON, one object per shape key)::

    {
      "fused_gemv_stacked|B=4,G=768,L=24,O=1536,R=4,V=256,bits=4,g=2,"
      "dtype=float32|backend=cuda:NVIDIA H100 80GB HBM3": {
        "design": "split",
        "us": 41.2,          # the winner's median microseconds, or null
                             # when it was recorded untimed
        "candidates": 2      # designs timed (1 when the guard admits one)
      }
    }

Keys keep the reference's kernel names and dimensions (the counter-carrying
launches under the ``*_sat`` families).  The backend part names the device:
``cpu``, or ``cuda:`` and the card's name, so a key recorded on one card is
never a hit on another, nor on the CPU.

The file lives at ``$REPRO_PCILT_TUNE_CACHE`` or
``~/.cache/repro-pcilt/tiles.json`` and is written atomically (tmp +
rename).  On save a process merges the freshest on-disk state with only the
keys it recorded itself.  ``us`` is ``null``, never ``NaN``.  A corrupt
file is warned about, renamed to ``<path>.corrupt-<ns>`` (the newest
:data:`QUARANTINE_KEEP` kept) and the cache starts empty.

Policy: lookup is always on (every CUDA launch in ``kernels.ops`` consults
the cache before its heuristic); tuning runs only when asked
(``autotune=True`` on the ``ops`` wrappers, or ``REPRO_PCILT_AUTOTUNE=1``),
and only on CUDA tensors unless a timer is given (:func:`tune_design`'s
``timer``, or :func:`using_timer` around the calls): the CPU runs each
kernel's plain version, so it has nothing to time.  ``kernels.ops``
memoises the design of each launch shape in process (:data:`MEMO`, emptied
by :func:`reset_cache`), so a warm launch costs one dict lookup; the
environment's default is read at a shape's first launch (a later
``autotune=True`` still tunes a memoised heuristic).
:data:`TIMING_RUNS` counts timed executions; it stays 0 on a warm cache.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import torch

log = logging.getLogger("repro_torch.autotune")

__all__ = ["DesignCache", "get_cache", "reset_cache", "shape_key",
           "lookup_design", "tune_design", "autotune_enabled",
           "backend_name", "cuda_timer", "using_timer", "injected_timer",
           "TIMING_RUNS", "TIMINGS", "QUARANTINE_KEEP", "MEMO"]

#: timed candidate executions (warm-up included); 0 on a warm cache
TIMING_RUNS = 0

#: quarantined copies of a corrupt cache file kept per path
QUARANTINE_KEEP = 3

_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro-pcilt", "tiles.json")

#: ``kernels.ops``' in-process memo: launch shape tuple -> ``(design,
#: from_cache)``; emptied by :func:`reset_cache`
MEMO: Dict[tuple, tuple] = {}

#: key -> {design: microseconds} of every candidate this process timed (the
#: file keeps the winner's only)
TIMINGS: Dict[str, Dict[str, float]] = {}


def _quarantine_path(path: str) -> str:
    return f"{path}.corrupt-{time.time_ns()}"


def _prune_quarantine(path: str, keep: int = QUARANTINE_KEEP) -> None:
    """Drop all but the ``keep`` newest quarantined copies of ``path``
    (ordered by the timestamp in their names)."""
    base = os.path.basename(path) + ".corrupt-"
    d = os.path.dirname(path) or "."
    try:
        names = [n for n in os.listdir(d) if n.startswith(base)
                 and n[len(base):].isdigit()]
    except OSError:
        return
    for stale in sorted(names, key=lambda n: int(n[len(base):]))[:-keep]:
        try:
            os.remove(os.path.join(d, stale))
        except OSError:
            pass


def _read_json(path: str, quarantine: bool = True) -> Dict[str, dict]:
    """A cache file's entries; ``{}`` when it is absent.  An unreadable
    file is warned about and (``quarantine``) renamed aside, its bytes kept
    for a post-mortem."""
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"top level is {type(data).__name__}, not an "
                             f"object")
        return data
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        qpath = _quarantine_path(path)
        log.warning("autotune cache %s is unreadable (%s: %s); starting "
                    "empty — corrupt file preserved at %s",
                    path, type(e).__name__, e, qpath)
        if quarantine:
            try:
                os.replace(path, qpath)
            except OSError:
                pass
            _prune_quarantine(path)
        return {}


def autotune_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve an ``autotune=`` argument against ``REPRO_PCILT_AUTOTUNE``."""
    if flag is not None:
        return flag
    return os.environ.get("REPRO_PCILT_AUTOTUNE", "0") not in ("", "0",
                                                               "false")


def shape_key(kernel: str, *, dtype, backend: str, **dims: int) -> str:
    """The key of one problem shape, e.g. ``fused_gemv|B=8,G=512,O=1024,
    V=16,bits=2,g=2,dtype=float32|backend=cpu``."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    parts = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
    return f"{kernel}|{parts},dtype={dtype}|backend={backend}"


_BACKENDS: Dict[torch.device, str] = {}


def backend_name(device) -> str:
    """``cpu``, or ``cuda:`` and the card's name (read once a device)."""
    dev = torch.device(device)
    name = _BACKENDS.get(dev)
    if name is None:
        if dev.type == "cuda":
            name = f"cuda:{torch.cuda.get_device_name(dev)}"
        else:
            name = dev.type
        _BACKENDS[dev] = name
    return name


class DesignCache:
    """The persistent shape key -> design table."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("REPRO_PCILT_TUNE_CACHE") \
            or _DEFAULT_CACHE
        self._entries: Dict[str, dict] = _read_json(self.path)
        #: keys recorded by this process: the only ones a save may write
        self._dirty: set = set()

    def _save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        merged = dict(_read_json(self.path))
        merged.update({k: self._entries[k] for k in self._dirty
                       if k in self._entries})
        for e in merged.values():  # a legacy NaN timing is written null
            if isinstance(e, dict) and isinstance(e.get("us"), float) \
                    and not math.isfinite(e["us"]):
                e["us"] = None
        self._entries = merged
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=1, sort_keys=True,
                      allow_nan=False)
        os.replace(tmp, self.path)

    def lookup(self, key: str) -> Optional[str]:
        """The recorded design, or None (a malformed entry is a miss)."""
        e = self._entries.get(key)
        if not isinstance(e, dict) or not isinstance(e.get("design"), str):
            return None
        return e["design"]

    def record(self, key: str, design: str, us: Optional[float],
               candidates: int) -> None:
        if us is not None and not math.isfinite(us):
            us = None
        self._entries[key] = {"design": design, "us": us,
                              "candidates": candidates}
        self._dirty.add(key)
        self._save()

    def entries(self) -> Dict[str, dict]:
        return dict(self._entries)


_CACHE: Optional[DesignCache] = None


def get_cache() -> DesignCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = DesignCache()
    return _CACHE


def reset_cache(path: Optional[str] = None) -> DesignCache:
    """Reload the cache from ``path`` (else the environment's or the default
    file) and empty the in-process memo: a fresh process sharing the file."""
    global _CACHE
    MEMO.clear()
    _CACHE = DesignCache(path)
    return _CACHE


def lookup_design(key: str) -> Optional[str]:
    """The recorded design of ``key`` (the reference's ``lookup``), or
    None."""
    return get_cache().lookup(key)


_FLUSH: Dict[torch.device, torch.Tensor] = {}
#: bytes the CUDA timer inverts before each timed launch (> 5x an H100's L2)
FLUSH_BYTES = 256 << 20


def cuda_timer(fn: Callable[[], None], reps: int = 5,
               warmup: int = 2) -> float:
    """The median device microseconds of ``fn`` (one launch on the current
    CUDA device): ``warmup`` calls, then ``reps`` calls, each behind an L2
    flush and between two CUDA events."""
    dev = torch.device("cuda", torch.cuda.current_device())
    buf = _FLUSH.get(dev)
    if buf is None:
        buf = _FLUSH[dev] = torch.zeros(FLUSH_BYTES, dtype=torch.uint8,
                                        device=dev)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        buf.bitwise_not_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


#: the timer :func:`tune_design` uses when given none (see :func:`using_timer`)
_TIMER: Optional[Callable] = None


@contextlib.contextmanager
def using_timer(timer: Callable):
    """Tuning inside the block times with ``timer(fn, reps, warmup) -> us``
    (the CPU tests inject a fake clock this way)."""
    global _TIMER
    before, _TIMER = _TIMER, timer
    try:
        yield
    finally:
        _TIMER = before


def injected_timer() -> Optional[Callable]:
    return _TIMER


def tune_design(key: str, candidates: Sequence[str],
         bench: Callable[[str], Callable[[], None]], reps: int = 5,
         warmup: int = 2, *, timer: Optional[Callable] = None) -> str:
    """The reference's ``tune`` over designs.  Hit -> the recorded design
    (nothing timed); miss -> time every candidate design and record the
    winner.

    ``bench(design)`` returns a nullary closure that launches the kernel
    once in that design.  ``timer(fn, reps, warmup)`` gives a candidate's
    microseconds (else the injected one, else :func:`cuda_timer`).  A
    candidate that fails to run is skipped; when none runs, or only one is
    given, the first is recorded untimed (``us`` null)."""
    global TIMING_RUNS
    cache = get_cache()
    hit = cache.lookup(key)
    if hit is not None and hit in candidates:
        return hit
    if len(candidates) == 1:
        cache.record(key, candidates[0], None, 1)
        return candidates[0]
    timer = timer or _TIMER or cuda_timer

    def counted(fn):
        def run():
            global TIMING_RUNS
            TIMING_RUNS += 1
            fn()
        return run

    best, best_us, tried = None, math.inf, 0
    for design in candidates:
        try:
            us = float(timer(counted(bench(design)), reps, warmup))
        except Exception as e:  # a design the shape rejects is skipped
            log.warning("autotune %s: design %r failed (%s: %s)", key,
                        design, type(e).__name__, e)
            continue
        tried += 1
        TIMINGS.setdefault(key, {})[design] = us
        if us < best_us:
            best, best_us = design, us
    if best is None:
        best, best_us = candidates[0], None
    cache.record(key, best, best_us, tried)
    return best
