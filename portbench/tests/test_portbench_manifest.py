"""``BENCHMARK.json`` against the benchmark contract, the files it names,
and the harness finding new files by their names alone."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, manifest

from . import smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()
#: the benchmark as it stands, and with the pending cells added
BOTH = pytest.mark.parametrize("bench", [BENCH, smoke.merged(BENCH)],
                               ids=["benchmark", "with-pending"])


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@BOTH
def test_names_units_and_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if group in ("configs", "workloads"):
                assert _line(e["why"])
            if group == "configs":
                assert _line(e["source"])
                assert len(e["reduced"]) <= 16
            if group == "per_layer":
                assert _line(e["layer"])
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


@BOTH
def test_metrics_and_their_arrows(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in cells:
            if reports(m, cell):
                assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert sum(reports(m, cell) for m in e2e.values()) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith(
                "_roofline")


@BOTH
def test_every_named_file_is_there(bench):
    assert {c["config"] for c in bench["workloads"]} == \
        {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        assert c["file"].startswith("portbench/configs/")
        manifest.module("kinds", cfg["kind"])
        manifest.module("reference", cfg["reference"])
    for w in bench["workloads"]:
        manifest.traffic(w["traffic"])
        lim = manifest.limits(w["name"])
        assert all(math.isfinite(n["limit"]) for n in lim["numbers"].values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer metric
    dropped into a copy, with their entries in its ``BENCHMARK.json``, run
    with no other edit."""
    root = smoke.make(tmp_path)
    pb = root / "portbench"
    shutil.copy(pb / "configs" / "paper-cnn.json",
                pb / "configs" / "paper-cnn-narrow.json")
    cfg = json.loads((pb / "configs" / "paper-cnn-narrow.json").read_text())
    (pb / "configs" / "paper-cnn-narrow.json").write_text(json.dumps(
        dict(cfg, channels=[4, 6, 8])))
    (pb / "traffic" / "frames-tiny.json").write_text(json.dumps(
        dict(json.loads((pb / "traffic" / "frames-1024x768.json")
                        .read_text()), shape=[1, 16, 12, 1])))
    shutil.copy(pb / "limits" / "cnn-1024x768.json",
                pb / "limits" / "cnn-tiny.json")
    (pb / "metrics" / "requests_served.tiny.py").write_text(
        "def read(rec):\n    return rec['window']['requests']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="paper-cnn-narrow",
                                 file="portbench/configs/paper-cnn-narrow.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="cnn-tiny",
                                   config="paper-cnn-narrow",
                                   traffic="frames-tiny"))
    bench["per_layer"].append({
        "name": "requests_served.tiny", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "images_per_s", "workloads": ["cnn-tiny"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "images_per_s")["workloads"].append("cnn-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rec, out = smoke.run(root, "cnn-tiny", seconds=0.5, trace=True)
    assert out["correct"]
    assert out["metrics"]["requests_served.tiny"]["value"] == \
        rec["window"]["requests"] >= 1
    assert len(rec["work"]["image"]["layers"]) == 3


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "cnn-1024x768", "--seed", "1",
                       "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "CUDA" in captured.err


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cnn-1024x768",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
