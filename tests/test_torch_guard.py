"""Guards of the port's ground rules.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` — checked on the source (every
  import statement) and in a fresh interpreter (``sys.modules``).
* Every entry point runs on CUDA unless the caller asks for the CPU: with
  no CUDA device, a call that does not pass ``device="cpu"`` raises instead
  of falling back.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.launch.quickstart, "
            "repro_torch.launch.learnable_pcilt, "
            "repro_torch.configs.paper_cnn\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.interop import params_from_jax, resolve_device
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(model.param_specs())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    params = materialize(model.param_specs(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_mamba_decode(model, params, torch.zeros(1, 4, dtype=torch.long))
    # asking for the CPU is the only way there
    assert params["embed"]["embedding"].device.type == "cpu"


@pytest.mark.parametrize("flags", [[], ["--pcilt"], ["--pcilt", "--chaos"],
                                   ["--traffic", "poisson"]])
def test_serve_cli_refuses_to_fall_back_to_cpu(flags):
    """``python -m repro_torch.launch.serve`` without ``--device cpu``
    demands CUDA, before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(flags)
