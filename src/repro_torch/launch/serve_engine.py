"""Continuous-batching serving demo (the port of
``examples/serve_engine.py``): six requests through the slot engine on
qwen3-0.6b's smoke config, 12 new tokens each over 3 slots, each prompt
replayed through the decode step into the engine's KV cache, finished slots
zeroed and recycled.

    python -m repro_torch.launch.serve_engine               # on CUDA
    python -m repro_torch.launch.serve_engine --device cpu  # on the CPU
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    serve_main(["--arch", "qwen3-0.6b", "--requests", "6", "--max-new", "12",
                "--slots", "3", "--device", args.device])


if __name__ == "__main__":
    main()
