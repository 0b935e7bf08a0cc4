"""No benchmark module imports JAX or the JAX package, and the references
import nothing of the program.  Top-level names are compared whole:
``repro_torch`` is not ``repro``."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness, manifest

SOURCES = sorted(p for p in manifest.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(manifest.HERE).parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(manifest.HERE)) for p in SOURCES])
def test_no_jax_in_the_benchmark(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((manifest.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"repro_torch", "repro", "jax"}


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "jaxlib", "flax"]) == [
            "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax():
    """Everything a run imports, the port's entry points with it, leaves
    ``sys.modules`` free of JAX and of the JAX package."""
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}];"
            "import portbench.harness as h, portbench.kinds.paper_cnn,"
            " portbench.kinds.mamba_decode;"
            "import repro_torch.launch.serve, repro_torch.models.cnn,"
            " repro_torch.core.serving, repro_torch.kernels.ops;"
            "print(h.forbidden_modules())").format(
                root=str(manifest.ROOT), src=str(manifest.ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
