"""Static contract checker for the port's CUDA kernels (port of
``repro.analysis``).

The port's kernels keep tables in the card's memory and stage slices of
them in shared memory, so a few budgets are load-bearing that ordinary
tests exercise only at the shapes they happen to launch: the 227 KiB of
dynamic shared memory a block (``kernels.ops.SMEM_LIMIT``), the grid's
65535 rows, clusters of up to 16 blocks, the registers of an SM.  This
package checks them statically, for every design the port admits over a
recorded sweep of shapes, without launching a kernel, in three passes
(``docs/static_analysis_torch.md`` lists the rules):

* :mod:`repro_torch.analysis.lint` — a lint over ``src/repro_torch`` and
  the CUDA sources: no bare ``assert`` in library code, float32
  accumulators in device code, no host calls in device code or host syncs
  in a launch path, and design-cache keys that hold every shape symbol a
  ``*_candidates`` generator reads;
* :mod:`repro_torch.analysis.smem` — the Hopper resource verifier (the
  counterpart of ``repro.analysis.vmem``): each design model of
  ``kernels.ops`` enumerated over the sweep, its shared memory, launch
  limits and tile coverage checked, and (given them) the built libraries'
  own plans and the ``ptxas`` resource reports held to the models;
* :mod:`repro_torch.analysis.schema` — the checked-in ``BENCH_pr*.json``
  artifacts and the design cache's JSON.

CLI: ``python -m repro_torch.analysis`` — ``file:line: RULE severity:
message`` findings, exit code 1 when an error finding is not in the
baseline, ``--write-baseline`` to accept the current findings.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional

__all__ = ["Finding", "Baseline", "repo_root", "rel", "run_all",
           "ANALYSIS_VERSION", "PASSES"]

#: bumped when finding fingerprints or pass semantics change incompatibly
ANALYSIS_VERSION = 1

SEVERITIES = ("error", "warning")

#: the passes :func:`run_all` knows, in the order it runs them
PASSES = ("lint", "smem", "schema")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source (or artifact) location.

    ``symbol`` is the enclosing function, kernel, design family or
    artifact key: it anchors the baseline fingerprint, so an accepted
    exception survives unrelated line drift in the same file."""

    rule: str            # e.g. "LINT001", "SMEM003", "SCHEMA002"
    severity: str        # "error" | "warning"
    path: str            # repo-relative where possible
    line: int            # 1-based; 0 for whole-file/artifact findings
    message: str
    symbol: str = ""     # enclosing def / kernel / family / JSON key

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"finding severity must be one of {SEVERITIES}, "
                f"got {self.severity!r} for rule {self.rule}")

    def fingerprint(self) -> str:
        """Line-free identity used by the baseline: rule, file, enclosing
        symbol and the message up to its first ``;`` (the shapes and values
        after it may drift)."""
        head = self.message.split(";")[0].strip()
        return f"{self.rule}|{self.path}|{self.symbol}|{head}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule} {self.severity}: {self.message}{sym}"


class Baseline:
    """Accepted exceptions: a JSON file of finding fingerprints.

    A finding whose fingerprint is listed is reported as baselined and does
    not gate.  The file records the analysis version, so a change of the
    fingerprint scheme invalidates a stale baseline loudly."""

    def __init__(self, fingerprints: Iterable[str] = (), path: str = ""):
        self.path = path
        self.fingerprints = set(fingerprints)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "accepted" not in data:
            raise ValueError(
                f"baseline {path} is not a {{'version', 'accepted': [...]}} "
                f"object")
        ver = data.get("version")
        if ver != ANALYSIS_VERSION:
            raise ValueError(
                f"baseline {path} was written for analysis version {ver}, "
                f"this is version {ANALYSIS_VERSION}; regenerate it with "
                f"--write-baseline")
        return cls(data["accepted"], path=path)

    @classmethod
    def write(cls, path: str, findings: Iterable[Finding]) -> "Baseline":
        fps = sorted({f.fingerprint() for f in findings})
        with open(path, "w") as f:
            json.dump({"version": ANALYSIS_VERSION, "accepted": fps},
                      f, indent=1, sort_keys=True)
            f.write("\n")
        return cls(fps, path=path)

    def accepts(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.fingerprints


def repo_root() -> str:
    """The repository root, from this package's location
    (``<root>/src/repro_torch/analysis`` -> ``<root>``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def rel(path: str, root: Optional[str] = None) -> str:
    root = root or repo_root()
    try:
        r = os.path.relpath(os.path.abspath(path), root)
    except ValueError:  # another drive: keep it absolute
        return path
    return path if r.startswith("..") else r


def run_all(root: Optional[str] = None, passes: Iterable[str] = PASSES,
            sweep: str = "quick", *, smem_budget: Optional[int] = None,
            libraries=None, reports=None) -> List[Finding]:
    """Run the requested passes over the repository; returns every
    finding, errors first.

    ``sweep`` selects the resource verifier's shape sweep (``quick`` |
    ``full``); ``smem_budget`` replaces ``kernels.ops.SMEM_LIMIT`` as the
    bytes of dynamic shared memory a design may model (a shrunk budget
    must make SMEM001 fire); ``libraries`` and ``reports`` (kernel library
    name -> a loaded library, or its ``ptxas`` report text) feed the
    resource verifier's drift and spill rules."""
    root = root or repo_root()
    passes = set(passes)
    unknown = passes - set(PASSES)
    if unknown:
        raise ValueError(f"unknown analysis passes: {sorted(unknown)} "
                         f"(valid: {', '.join(PASSES)})")
    findings: List[Finding] = []
    if "lint" in passes:
        from repro_torch.analysis import lint
        findings.extend(lint.lint_tree(
            os.path.join(root, "src", "repro_torch"), root=root))
    if "smem" in passes:
        from repro_torch.analysis import smem
        findings.extend(smem.verify_all(sweep=sweep, smem_budget=smem_budget,
                                        libraries=libraries,
                                        reports=reports, root=root))
    if "schema" in passes:
        from repro_torch.analysis import schema
        findings.extend(schema.validate_repo_artifacts(root))
    order = {"error": 0, "warning": 1}
    findings.sort(key=lambda f: (order[f.severity], f.path, f.line, f.rule))
    return findings
