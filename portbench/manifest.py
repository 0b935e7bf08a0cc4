"""``BENCHMARK.json`` and the files it names, each found by its name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    """The configuration file of ``name`` (its ``"file"``), with its name."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return dict(json.load(f), name=name)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _data(kind: str, name: str, root: Path) -> Dict:
    with open(Path(root) / "portbench" / kind / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> Dict:
    return _data("traffic", name, root)


def limits(workload_name: str, root: Path = ROOT) -> Dict:
    return _data("limits", workload_name, root)


def metrics(bench: Dict, workload_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the workload reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on (each that lists the
    workload, or lists none)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload_name in m.get("workloads", [workload_name])]


def reader(name: str, root: Path = ROOT) -> Callable[[Dict], Optional[float]]:
    """The ``read(rec)`` of ``metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def module(package: str, name: str):
    """``portbench.<package>.<name>`` (a kind or a reference)."""
    return importlib.import_module(f"portbench.{package}.{name}")
