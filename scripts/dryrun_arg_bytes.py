"""The bytes of arguments a device holds in each of chip_smoke.py's phase-25
dry-run cells, reckoned from the partition specs alone (no step runs).

    PYTHONPATH=src python scripts/dryrun_arg_bytes.py

For each cell the production mesh is laid out on ``meta`` devices and
``launch.specs.input_specs`` placed on it (``step_args``: a block a
coordinate, nothing allocated); the busiest coordinate's bytes are printed
beside the parameters', the optimizer state's, the cache's and the batch's
(a whole batch tensor sits at the mesh's first coordinate, where the port's
step takes it).  ``tests/test_torch_specs.py`` holds every block shape to
the reference's ``sharding.shard_shape``.
"""

import sys

import torch

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import _coord_bytes, _skip_reason
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, step_args

CELLS = (("qwen3-0.6b", "decode_32k", False),
         ("qwen3-0.6b", "prefill_32k", False),
         ("qwen3-0.6b", "train_4k", False),
         ("granite-moe-3b-a800m", "train_4k", False),
         ("mamba2-130m", "long_500k", False),
         ("llama4-maverick-400b-a17b", "train_4k", True))


def main() -> int:
    for arch, shape, mp in CELLS:
        cfg = get_config(arch)
        if _skip_reason(cfg, shape):
            continue
        n = 512 if mp else 256
        mesh = make_production_mesh(multi_pod=mp,
                                    devices=[torch.device("meta")] * n)
        args = step_args(input_specs(arch, shape, mesh))
        parts = {k: _coord_bytes(v, mesh) for k, v in args.items()}
        total = _coord_bytes(tuple(args.values()), mesh)
        c = max(total, key=lambda c: (total[c], [-i for i in c]))
        detail = ", ".join(f"{k} {parts[k].get(c, 0) / 1e9:.3f}"
                           for k in args)
        print(f"{arch} {shape} {'pod2x16x16' if mp else 'pod16x16'}: "
              f"{total[c] / 1e9:.3f} GB at {c} ({detail}); least "
              f"{min(total.values()) / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
