#!/usr/bin/env bash
# Static analysis of the PyTorch/CUDA port: the lint, the Hopper resource
# verifier and the artifact schemas (see docs/static_analysis_torch.md).
# Launches no kernel; seconds on a CPU.
# Usage: scripts/lint_torch.sh [extra repro_torch.analysis args...]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
exec python -m repro_torch.analysis "$@"
