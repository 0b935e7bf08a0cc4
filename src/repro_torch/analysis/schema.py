"""Versioned schemas for the repository's JSON artifacts (port of
``repro.analysis.schema``).

* the **benchmark payloads** (``BENCH_pr*.json``, checked in): top-level
  metadata plus ``rows`` of ``{"name", "us_per_call", "derived"}``,
  ``skipped`` rows carrying both the row's reason and an entry in the
  top-level ``skipped`` map, the ``traffic`` and ``drift`` blocks.  The
  validator is the reference's, copied (**SCHEMA001**).
* the port's **design cache** (``kernels/autotune.py``): a flat map of
  shape keys to ``{"design": str, "us": null | finite, "candidates":
  int}``.  The key grammar is ``autotune.shape_key``'s
  (``kernel|dim=val,...,dtype=D|backend=B``, the backend ``cpu`` or
  ``cuda:<card name>``); each kernel family carries the dimensions of its
  ``kernels.ops`` key and names one of its designs (the keys of
  ``GEMV_VARIANT_LAUNCHES`` and its siblings); a timed ``us`` with
  ``candidates: 0`` is a contradiction (**SCHEMA002**).

Validation is hand-rolled (no jsonschema dependency) and versioned:
``BENCH_SCHEMA_VERSION`` / ``CACHE_SCHEMA_VERSION``; loosening a rule bumps
the version and the catalogue in ``docs/static_analysis_torch.md``.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import Finding, rel

__all__ = [
    "RULES",
    "BENCH_SCHEMA_VERSION",
    "CACHE_SCHEMA_VERSION",
    "KNOWN_KERNELS",
    "DESIGNS",
    "parse_design_key",
    "validate_bench",
    "validate_design_cache",
    "validate_repo_artifacts",
]

RULES: Dict[str, str] = {
    "SCHEMA001": "a checked-in BENCH_pr*.json artifact violates the "
                 "benchmark schema",
    "SCHEMA002": "the design cache (REPRO_PCILT_TUNE_CACHE or a committed "
                 "*tiles*.json) violates the design-cache schema",
}

BENCH_SCHEMA_VERSION = 1
CACHE_SCHEMA_VERSION = 1

_GEMV = ("B", "G", "V", "O", "g", "bits")
_STACKED = ("B", "R", "L", "G", "V", "O", "g", "bits")
_DWCONV = ("B", "T", "C", "V", "k", "bits")
_CONV = ("B", "Ho", "W", "C", "k", "s", "G", "V", "O", "g", "bits")

#: kernel family -> the dimensions its key carries (``kernels.ops``'
#: ``_choose`` keys: the reference's names and dimensions, the counter-
#: carrying launches under ``*_sat``, and the port's own host-packed
#: dwconv).  A key may carry more (additive evolution); missing one is a
#: violation.
KNOWN_KERNELS: Dict[str, Tuple[str, ...]] = {
    "fused_gemv": _GEMV,
    "fused_gemv_stacked": _STACKED,
    "fused_gemv_stacked_sat": _STACKED,
    "fused_gemv_paired": _GEMV,
    "fused_gemv_paired_sat": _GEMV,
    "fused_gemv_paired_stacked": _STACKED,
    "fused_gemv_paired_stacked_sat": _STACKED,
    "fused_gemv_plan": _GEMV,
    "fused_dwconv1d": _DWCONV,
    "fused_dwconv1d_sat": _DWCONV,
    "dwconv1d_host": ("B", "T", "C", "V"),
    "shared_gemv": ("B", "G", "V", "O", "X", "g", "bits"),
    "gemv_host": ("B", "G", "V", "O"),
    "conv2d_host": ("B", "Ho", "Wo", "G", "V", "O"),
    "fused_conv2d": _CONV,
    "shared_conv2d": _CONV + ("X",),
}


def _designs() -> Dict[str, Tuple[str, ...]]:
    """Kernel family -> the designs ``kernels.ops`` counts for it."""
    from repro_torch.kernels import ops

    by_prefix = (("fused_gemv", ops.GEMV_VARIANT_LAUNCHES),
                 ("fused_dwconv1d", ops.DWCONV_VARIANT_LAUNCHES),
                 ("dwconv1d_host", ops.DWCONV_HOST_VARIANT_LAUNCHES),
                 ("shared_gemv", ops.SHARED_GEMV_VARIANT_LAUNCHES),
                 ("gemv_host", ops.GEMV_HOST_VARIANT_LAUNCHES),
                 ("conv2d_host", ops.GEMV_HOST_VARIANT_LAUNCHES),
                 ("fused_conv2d", ops.CONV_VARIANT_LAUNCHES),
                 ("shared_conv2d", ops.CONV_VARIANT_LAUNCHES))
    out = {}
    for kernel in KNOWN_KERNELS:
        counts = next(c for p, c in by_prefix if kernel.startswith(p))
        out[kernel] = tuple(counts)
    return out


#: kernel family -> its designs (filled from ``kernels.ops`` at first use)
DESIGNS: Dict[str, Tuple[str, ...]] = {}

_KEY_RE = re.compile(
    r"^(?P<kernel>[a-z0-9_]+)\|"
    r"(?P<dims>(?:[A-Za-z]\w*=[^,|]+,)*)"
    r"dtype=(?P<dtype>[^,|]+)"
    r"\|backend=(?P<backend>cpu|cuda:[^|]+)$")


def parse_design_key(key: str) -> Tuple[str, Dict[str, int], str, str]:
    """Parse ``kernel|d1=v1,...,dtype=D|backend=B`` -> (kernel, dims, dtype,
    backend); the backend is ``cpu`` or ``cuda:`` and a card's name.
    Raises ``ValueError`` naming the malformed piece."""
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(
            f"shape key does not match 'kernel|dim=val,...,dtype=<dtype>|"
            f"backend=<cpu|cuda:name>': {key!r}")
    dims: Dict[str, int] = {}
    for part in filter(None, m.group("dims").rstrip(",").split(",")):
        name, _, val = part.partition("=")
        try:
            dims[name] = int(val)
        except ValueError:
            raise ValueError(
                f"shape-key dim {name!r} has non-integer value {val!r} "
                f"in key {key!r}") from None
    return m.group("kernel"), dims, m.group("dtype"), m.group("backend")


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _finite_num(x) -> bool:
    return _is_num(x) and math.isfinite(x)


# ----------------------------------------------------------------------------
# The design cache
# ----------------------------------------------------------------------------

_DTYPES = ("float32", "bfloat16")


def validate_design_cache(obj, path: str = "<cache>") -> List[Finding]:
    """Validate one design-cache payload (the parsed JSON object)."""
    out: List[Finding] = []
    if not DESIGNS:
        DESIGNS.update(_designs())

    def err(msg: str, key: str = "") -> None:
        out.append(Finding("SCHEMA002", "error", path, 0, msg, symbol=key))

    if not isinstance(obj, dict):
        err(f"cache root must be an object mapping shape keys to entries, "
            f"got {type(obj).__name__}")
        return out
    for key, entry in obj.items():
        try:
            kernel, dims, dtype, _ = parse_design_key(key)
        except ValueError as e:
            err(f"bad shape key: {e}", key)
            continue
        if kernel not in KNOWN_KERNELS:
            err(f"unknown kernel family {kernel!r} "
                f"(known: {sorted(KNOWN_KERNELS)})", key)
        else:
            missing = [d for d in KNOWN_KERNELS[kernel] if d not in dims]
            if missing:
                err(f"key for kernel {kernel!r} is missing required dims "
                    f"{missing}; present: {sorted(dims)}", key)
        if dtype not in _DTYPES:
            err(f"key dtype {dtype!r} is not a table dtype {_DTYPES}", key)
        nonpos = {d: v for d, v in dims.items() if v < 1}
        if nonpos:
            err(f"key carries non-positive dims {nonpos}", key)
        if not isinstance(entry, dict):
            err(f"entry must be an object, got {type(entry).__name__}", key)
            continue
        extra = set(entry) - {"design", "us", "candidates"}
        if extra:
            err(f"entry carries unknown fields {sorted(extra)} "
                f"(schema v{CACHE_SCHEMA_VERSION} allows design/us/"
                f"candidates)", key)
        design = entry.get("design")
        if not isinstance(design, str):
            err(f"entry 'design' must be a string, got {design!r}", key)
        elif kernel in DESIGNS and design not in DESIGNS[kernel]:
            err(f"design {design!r} is not one of {kernel!r}'s designs "
                f"{list(DESIGNS[kernel])}", key)
        us = entry.get("us", "<absent>")
        if us == "<absent>":
            err("entry is missing 'us' (null when the design was recorded "
                "untimed)", key)
        elif us is not None and not _finite_num(us):
            err(f"'us' must be null or a finite number, got {us!r} "
                f"(bare NaN/Infinity tokens break strict parsers)", key)
        cand = entry.get("candidates")
        if not isinstance(cand, int) or isinstance(cand, bool) or cand < 0:
            err(f"'candidates' must be a non-negative int, got {cand!r}",
                key)
        elif us is not None and us != "<absent>" and cand == 0:
            err("entry has a timed 'us' but candidates=0; a timing with no "
                "timed candidate is contradictory", key)
    return out


# ----------------------------------------------------------------------------
# BENCH_*.json schema (the reference's validator, copied)
# ----------------------------------------------------------------------------

_ROW_NAME_RE = re.compile(r"^[a-z0-9_]+\.[A-Za-z0-9_.\-]+$")


def validate_bench(obj, path: str = "<bench>") -> List[Finding]:
    """Validate one BENCH payload (the parsed JSON object)."""
    out: List[Finding] = []

    def err(msg: str, sym: str = "") -> None:
        out.append(Finding("SCHEMA001", "error", path, 0, msg, symbol=sym))

    if not isinstance(obj, dict):
        err(f"BENCH root must be an object, got {type(obj).__name__}")
        return out
    if not isinstance(obj.get("pr"), int) or isinstance(obj.get("pr"), bool):
        err(f"top-level 'pr' must be an int, got {obj.get('pr')!r}")
    for field in ("backend", "timing"):
        if not isinstance(obj.get(field), str) or not obj.get(field):
            err(f"top-level {field!r} must be a non-empty string, "
                f"got {obj.get(field)!r}")
    skipped = obj.get("skipped", {})
    if not isinstance(skipped, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in skipped.items()):
        err(f"top-level 'skipped' must map sub-benchmark names to string "
            f"reasons, got {skipped!r}")
        skipped = {}
    rows = obj.get("rows")
    if not isinstance(rows, list) or not rows:
        err("top-level 'rows' must be a non-empty list")
        rows = []
    row_skips = set()
    for i, row in enumerate(rows):
        sym = f"rows[{i}]"
        if not isinstance(row, dict):
            err(f"row must be an object, got {type(row).__name__}", sym)
            continue
        name = row.get("name")
        if not isinstance(name, str) or not _ROW_NAME_RE.match(name):
            err(f"row 'name' must be a '<section>.<case>' string, "
                f"got {name!r}", sym)
        else:
            sym = name
        missing = {"name", "us_per_call", "derived"} - set(row)
        if missing:
            err(f"row is missing required fields {sorted(missing)}", sym)
        extra = set(row) - {"name", "us_per_call", "derived", "skipped"}
        if extra:
            err(f"row carries unknown fields {sorted(extra)} "
                f"(schema v{BENCH_SCHEMA_VERSION})", sym)
        us = row.get("us_per_call")
        if "us_per_call" in row and not _finite_num(us):
            err(f"row 'us_per_call' must be a finite number, got {us!r}", sym)
        der = row.get("derived")
        if "derived" in row and not (isinstance(der, str) or _finite_num(der)):
            err(f"row 'derived' must be a string or finite number, "
                f"got {der!r}", sym)
        skip = row.get("skipped")
        if skip is not None:
            if not isinstance(skip, str) or not skip:
                err(f"row 'skipped' must be a non-empty reason string, "
                    f"got {skip!r}", sym)
            if "derived" in row and not (
                    isinstance(der, str) and der.startswith("skipped: ")):
                err("skipped row's 'derived' must carry the "
                    "'skipped: <reason>' marker (the CSV mirror)", sym)
            if isinstance(name, str):
                row_skips.add(name)
                if name not in skipped:
                    err("skipped row has no entry in the top-level 'skipped' "
                        "map — the two views must agree", sym)
    for name in skipped:
        if name not in row_skips:
            err(f"top-level 'skipped' names {name!r} but no row carries the "
                f"skip — the two views must agree", name)
    # speedup blocks, when present, are flat name -> finite number maps.
    for field in ("speedup", "target_min_speedup"):
        block = obj.get(field)
        if block is None:
            continue
        if not isinstance(block, dict) or not all(
                isinstance(k, str) and _finite_num(v)
                for k, v in block.items()):
            err(f"top-level {field!r} must map metric names to finite "
                f"numbers, got {block!r}")
    # traffic block (BENCH_pr9+): open-loop load-sweep rows.  Each row
    # carries the typed outcome counts, and the counts must partition the
    # offered set — the overload-accounting invariant is enforced at the
    # artifact layer too, so a stale/hand-edited BENCH file cannot claim a
    # contract the engine did not uphold.
    traffic = obj.get("traffic")
    if traffic is not None:
        out.extend(_validate_traffic(traffic, err))
    # drift block (BENCH_pr10+): sentinel overhead + chaos-drift counts.
    drift = obj.get("drift")
    if drift is not None:
        _validate_drift(drift, err)
    return out


_DRIFT_CHAOS_COUNTS = ("demotions", "recalibrations", "sticky")


def _validate_drift(drift, err) -> None:
    """Validate a BENCH 'drift' block: the sentinel-overhead measurement
    (monitored vs unmonitored decode) and the chaos-drift event counts.
    The overhead ratio must actually be the quotient of the two timings —
    a hand-edited ratio cannot claim an overhead the timings don't show."""
    if not isinstance(drift, dict):
        err(f"top-level 'drift' must be an object, got "
            f"{type(drift).__name__}")
        return
    so = drift.get("sentinel_overhead")
    if not isinstance(so, dict):
        err(f"drift 'sentinel_overhead' must be an object with "
            f"monitored_us/unmonitored_us/ratio, got {so!r}",
            "drift.sentinel_overhead")
    else:
        vals = {}
        for f in ("monitored_us", "unmonitored_us", "ratio"):
            v = so.get(f)
            if not _finite_num(v) or v <= 0:
                err(f"drift sentinel_overhead.{f} must be a positive finite "
                    f"number, got {v!r}", "drift.sentinel_overhead")
            else:
                vals[f] = v
        if len(vals) == 3:
            q = vals["monitored_us"] / vals["unmonitored_us"]
            if abs(vals["ratio"] - q) > 0.01 * q:
                err(f"drift sentinel_overhead.ratio = {vals['ratio']:.4f} "
                    f"is not monitored_us/unmonitored_us = {q:.4f}",
                    "drift.sentinel_overhead")
    chaos = drift.get("chaos")
    if chaos is not None:
        if not isinstance(chaos, dict):
            err(f"drift 'chaos' must be an object, got "
                f"{type(chaos).__name__}", "drift.chaos")
        else:
            for f in _DRIFT_CHAOS_COUNTS:
                v = chaos.get(f)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    err(f"drift chaos.{f} must be a non-negative int, "
                        f"got {v!r}", "drift.chaos")
            rp = chaos.get("repromoted")
            if not isinstance(rp, bool):
                err(f"drift chaos.repromoted must be a bool, got {rp!r}",
                    "drift.chaos")
    extra = set(drift) - {"sentinel_overhead", "chaos"}
    if extra:
        err(f"drift block carries unknown fields {sorted(extra)} "
            f"(schema v{BENCH_SCHEMA_VERSION})", "drift")


_TRAFFIC_COUNTS = ("offered", "served", "degraded", "failed", "rejected")
_TRAFFIC_METRICS = ("shed_rate", "p50_token_s", "p99_token_s", "tokens_per_s")


def _validate_traffic(traffic, err) -> List[Finding]:
    """Validate a BENCH 'traffic' block: a list of load-sweep rows."""
    if not isinstance(traffic, list) or not traffic:
        err(f"top-level 'traffic' must be a non-empty list of load rows, "
            f"got {type(traffic).__name__}")
        return []
    for i, row in enumerate(traffic):
        sym = f"traffic[{i}]"
        if not isinstance(row, dict):
            err(f"traffic row must be an object, got {type(row).__name__}",
                sym)
            continue
        prof = row.get("profile")
        if not isinstance(prof, str) or not prof:
            err(f"traffic row 'profile' must be a non-empty string, "
                f"got {prof!r}", sym)
        else:
            sym = f"traffic[{i}]:{prof}@{row.get('load')}"
        if not _finite_num(row.get("load")) or row.get("load") <= 0:
            err(f"traffic row 'load' must be a positive finite number "
                f"(offered-load multiple of capacity), got "
                f"{row.get('load')!r}", sym)
        counts = {}
        for f in _TRAFFIC_COUNTS:
            v = row.get(f)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                err(f"traffic row {f!r} must be a non-negative int, "
                    f"got {v!r}", sym)
            else:
                counts[f] = v
        if len(counts) == len(_TRAFFIC_COUNTS):
            total = sum(counts[f] for f in _TRAFFIC_COUNTS[1:])
            if total != counts["offered"]:
                err(f"traffic row breaks the accounting invariant: "
                    f"served+degraded+failed+rejected = {total} != offered "
                    f"= {counts['offered']}", sym)
        for f in _TRAFFIC_METRICS:
            v = row.get(f)
            # percentile metrics are null when nothing completed (pure shed)
            if v is None and f in ("p50_token_s", "p99_token_s",
                                   "tokens_per_s"):
                continue
            if not _finite_num(v) or v < 0:
                err(f"traffic row {f!r} must be a non-negative finite "
                    f"number (or null for empty percentiles), got {v!r}",
                    sym)
    return []


# ----------------------------------------------------------------------------
# Repo artifact discovery
# ----------------------------------------------------------------------------


def _load(path: str) -> Tuple[Optional[object], Optional[str]]:
    try:
        with open(path) as f:
            return json.load(f), None
    except (OSError, ValueError) as e:
        return None, f"{type(e).__name__}: {e}"


def validate_repo_artifacts(root: str, cache_path: Optional[str] = None
                            ) -> List[Finding]:
    """Validate every checked-in ``BENCH_*.json`` under ``root`` and the
    design cache: an explicit ``cache_path``, else
    ``$REPRO_PCILT_TUNE_CACHE`` when it is set and exists, and any
    committed ``*tiles*.json`` at the root.  A missing cache is fine; an
    unreadable artifact is a finding, not a crash."""
    out: List[Finding] = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_*.json"))):
        obj, emsg = _load(path)
        if emsg is not None:
            out.append(Finding("SCHEMA001", "error", rel(path, root), 0,
                               f"unreadable BENCH file ({emsg})"))
            continue
        out.extend(validate_bench(obj, rel(path, root)))
    caches = []
    if cache_path:
        caches.append(cache_path)
    else:
        env = os.environ.get("REPRO_PCILT_TUNE_CACHE")
        if env and os.path.exists(env):
            caches.append(env)
        caches.extend(sorted(glob.glob(os.path.join(root, "*tiles*.json"))))
    for path in caches:
        obj, emsg = _load(path)
        if emsg is not None:
            out.append(Finding("SCHEMA002", "error", rel(path, root), 0,
                               f"unreadable design cache ({emsg})"))
            continue
        out.extend(validate_design_cache(obj, rel(path, root)))
    return out
