"""Device traces: ``torch.profiler`` over a short stretch of a run, cut into
labelled segments by marker kernels the benchmark launches itself.

A traced stretch opens with ``OPENING`` markers (``torch.cuda._sleep``'s
``spin_kernel``): late in a long process the profiler can drop the first
device records of a window, and a marker takes that loss.  The run
then launches one marker before each segment it wants told apart (a
decode step, a convolution); the device runs one stream in order, so the
operations between two markers belong to the segment the first opened.
A stretch that kept fewer markers than its segments plus one is refused
and profiled again.  The trace goes to a file under ``TMPDIR``, is read
and deleted.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

MARKER = "spin_kernel"
MARKER_CYCLES = 1000
OPENING = 3
#: host idle time around a stretch, so its device records lie well inside
PAD_S = 0.02
#: the port's own kernels (``src/repro_torch/kernels/csrc``), by name
PORT_KERNEL = re.compile(r"\b(gemv|shared|dwconv1d|conv2d|crc)[a-z0-9_]*_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Event = Tuple[str, float, float]  # name, start, end (microseconds)


def marker(torch) -> None:
    torch.cuda._sleep(MARKER_CYCLES)


def warm(torch) -> None:
    """Start and stop the profiler once, so that a traced run's first
    stretch does not pay the tracer's start inside the window."""
    with Stretch(torch):
        marker(torch)


class Stretch:
    """``with Stretch(torch) as s:`` profiles the device over the block;
    afterwards ``s.window_s`` is the block's host seconds (from after the
    opening markers ran to the closing synchronisation) and ``s.events``
    the device operations in start order.  The trace is read as the block
    closes: a later profiler start reuses the tracer's buffers, and a
    trace read after one holds operations of no duration."""

    def __init__(self, torch):
        self.torch = torch
        self.window_s = 0.0
        self.events: List[Event] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(PAD_S)
        for _ in range(OPENING):
            marker(torch)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        time.sleep(PAD_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = device_events(self._prof)
        del self._prof
        return False


def device_events(prof) -> List[Event]:
    """The device operations of a finished profile, in start order."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in evs if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(out, key=lambda e: e[1])


def segments(events: Sequence[Event], labels: Sequence[str]
             ) -> Optional[Dict[str, List[Event]]]:
    """Cut ``events`` at their markers: the last ``len(labels)`` markers open
    the segments ``labels`` in order (a label may repeat: its segments are
    joined).  None when fewer than ``len(labels) + 1`` markers survive or
    more than ``len(labels) + OPENING`` are there."""
    marks = [i for i, e in enumerate(events) if MARKER in e[0]]
    n = len(labels)
    if not n + 1 <= len(marks) <= n + OPENING:
        return None
    body = marks[len(marks) - n:]
    out: Dict[str, List[Event]] = {label: [] for label in labels}
    for j, i in enumerate(body):
        end = body[j + 1] if j + 1 < n else len(events)
        out[labels[j]].extend(events[i + 1:end])
    return out


def busy_s(events: Sequence[Event]) -> float:
    """Seconds in which some device operation ran (the union of their
    intervals), markers left out."""
    total, end = 0.0, None
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        if MARKER in name:
            continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def device_s(events: Sequence[Event]) -> float:
    return sum(e - s for name, s, e in events if MARKER not in name) / 1e6


def launches(events: Sequence[Event], port_only: bool = False) -> int:
    return sum(1 for name, _, _ in events if MARKER not in name
               and (not port_only or PORT_KERNEL.search(name)))


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """``[[name, seconds], ...]``: the ``n`` device operations that took the
    most time in all, by name."""
    tot: Dict[str, float] = {}
    for name, s, e in events:
        if MARKER not in name:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:160], v] for k, v in top]


def idle_gaps(events: Sequence[Event], labels: Sequence[str],
              what: Dict[str, str], n: int = 10) -> List[list]:
    """``[[what the host was doing, seconds], ...]``: the ``n`` longest idle
    gaps between consecutive device operations from the first segment
    marker on, each named by ``what`` of the segment of the operation that
    ends it (so the gap a segment opens with, while the host prepared it,
    is its own).  Markers are left out."""
    marks = [i for i, e in enumerate(events) if MARKER in e[0]]
    body = marks[len(marks) - len(labels):]
    gaps, end, label = [], None, None
    for k in range(body[0], len(events)):
        name, s, e = events[k]
        if k in body:
            label = labels[body.index(k)]
            continue
        if end is not None and s > end:
            gaps.append([what.get(label, label), (s - end) / 1e6])
        end = e if end is None else max(end, e)
    return sorted(gaps, key=lambda g: -g[1])[:n]
