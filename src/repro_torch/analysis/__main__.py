"""CLI of the port's static contract checker (port of
``repro.analysis.__main__``).

    python -m repro_torch.analysis                   # every pass, quick sweep
    python -m repro_torch.analysis --passes lint     # the lint alone
    python -m repro_torch.analysis --sweep full      # the full shape sweep
    python -m repro_torch.analysis --built           # also against the built
                                                     # libraries and reports
    python -m repro_torch.analysis --write-baseline  # accept the findings

Findings print as ``file:line: RULE severity: message [symbol]``.  The
exit code is 1 when an *error* finding is not in the baseline
(``<root>/.analysis-baseline-torch.json`` by default; warnings never
gate), 2 on a usage or baseline error, else 0.  Nothing is launched:
``--built`` loads each kernel library (``kernels.build``, which needs
``nvcc`` or a finished build) for its constants and plans and reads its
``ptxas`` report.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis import PASSES, Baseline, Finding, repo_root, run_all

DEFAULT_BASELINE = ".analysis-baseline-torch.json"


def built_inputs():
    """``(libraries, reports)`` of every kernel library, built if needed
    (``kernels.build``): loaded, never launched."""
    from repro_torch.kernels import build

    build.build_all()
    return ({n: build.library(n) for n in build.SOURCES},
            {n: build.report(n) for n in build.SOURCES})


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks of the port's kernel invariants, Hopper "
                    "resource budgets and artifact schemas.")
    p.add_argument("--passes", default=",".join(PASSES),
                   help=f"comma-separated subset of: {', '.join(PASSES)}")
    p.add_argument("--sweep", default="quick", choices=("quick", "full"),
                   help="the resource verifier's shape sweep (default: "
                        "quick)")
    p.add_argument("--root", default=None,
                   help="repository root (default: derived from the package "
                        "location)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file of accepted finding fingerprints "
                        f"(default: <root>/{DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline file "
                        "and exit 0")
    p.add_argument("--smem-budget", type=int, default=None,
                   help="override kernels.ops.SMEM_LIMIT bytes for the "
                        "smem pass (soundness experiments)")
    p.add_argument("--built", action="store_true",
                   help="hold the smem models to the built kernel libraries "
                        "and their ptxas reports (needs nvcc or a build)")
    args = p.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else repo_root()
    passes = tuple(s.strip() for s in args.passes.split(",") if s.strip())
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    libraries = reports = None
    try:
        if args.built:
            libraries, reports = built_inputs()
        findings = run_all(root=root, passes=passes, sweep=args.sweep,
                           smem_budget=args.smem_budget,
                           libraries=libraries, reports=reports)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        Baseline.write(baseline_path, findings)
        print(f"wrote {len(findings)} accepted fingerprint(s) to "
              f"{baseline_path}")
        return 0

    try:
        baseline = Baseline.load(baseline_path)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    gating: List[Finding] = []
    n_base = n_warn = 0
    for f in findings:
        suffix = ""
        if baseline.accepts(f):
            n_base += 1
            suffix = "  (baselined)"
        elif f.severity == "warning":
            n_warn += 1
        else:
            gating.append(f)
        print(f.render() + suffix)
    print(f"repro_torch.analysis: {len(findings)} finding(s) — "
          f"{len(gating)} error(s), {n_warn} warning(s), {n_base} baselined "
          f"[passes: {','.join(passes)}; sweep: {args.sweep}]")
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
