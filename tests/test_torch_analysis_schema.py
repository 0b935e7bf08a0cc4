"""The port's artifact schemas (``repro_torch.analysis.schema``).

* SCHEMA001 is the reference's benchmark validator, copied: every
  checked-in ``BENCH_pr*.json`` (and a corrupted copy of each) gives the
  same findings under both packages.
* SCHEMA002 holds the port's design cache: a cache that ``tune_design``
  writes on the CPU under an injected timer, for every kernel family whose
  wrapper tunes there, validates clean, and its keys carry exactly the
  dimensions ``KNOWN_KERNELS`` lists; seeded corruptions fire; the
  environment's cache and committed ``*tiles*.json`` files are read.
"""

import copy
import glob
import itertools
import json
import os

import pytest
import torch

from repro.analysis import schema as jschema
from repro_torch.analysis import repo_root, schema
from repro_torch.core import QuantSpec
from repro_torch.kernels import autotune as atn
from repro_torch.kernels import ops

ROOT = repo_root()
BENCH = sorted(glob.glob(os.path.join(ROOT, "BENCH_pr*.json")))
H100 = "cuda:NVIDIA H100 80GB HBM3"


def _key(f):
    return (f.rule, f.severity, f.path, f.line, f.message, f.symbol)


# ----------------------------------------------------------------------------
# SCHEMA001: the checked-in benchmark artifacts
# ----------------------------------------------------------------------------


def test_checked_in_bench_files_exist_and_validate_clean():
    assert len(BENCH) >= 8
    assert schema.validate_repo_artifacts(ROOT) == []


def _corrupt(obj):
    """The same payload with a row's timing made NaN-like, a skip made
    one-sided and the pr made a string."""
    bad = copy.deepcopy(obj)
    bad["pr"] = str(bad.get("pr"))
    bad["rows"][0]["us_per_call"] = "fast"
    bad["skipped"] = dict(bad.get("skipped", {}), **{"ghost.row": "gone"})
    return bad


@pytest.mark.parametrize("path", BENCH, ids=os.path.basename)
def test_bench_findings_equal_the_reference(path):
    with open(path) as f:
        obj = json.load(f)
    name = os.path.relpath(path, ROOT)
    for payload in (obj, _corrupt(obj)):
        got = [_key(f) for f in schema.validate_bench(payload, name)]
        want = [_key(f) for f in jschema.validate_bench(payload, name)]
        assert got == want
    assert schema.validate_bench(_corrupt(obj), name)


# ----------------------------------------------------------------------------
# SCHEMA002: the design cache
# ----------------------------------------------------------------------------


@pytest.fixture
def tune_cache(tmp_path):
    path = str(tmp_path / "tiles.json")
    atn.reset_cache(path)
    atn.TIMING_RUNS = 0
    yield path
    atn.TIMING_RUNS = 0
    atn.reset_cache(str(tmp_path / "after.json"))


def _fake_timer():
    it = itertools.cycle((5.0, 3.0, 4.0))

    def timer(fn, reps, warmup):
        fn()
        return next(it)

    return timer


def _tune_every_family():
    """One tuned call of each wrapper that consults the cache on the CPU
    (random operands: only the keys and designs matter)."""
    g = torch.Generator().manual_seed(3)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    s2 = QuantSpec(2)
    tabs = rn(4, 16, 8)
    ops.pcilt_fused_gemv(rn(3, 8), tabs, s2, 0.3, 2, autotune=True)
    for stats in (False, True):
        ops.pcilt_fused_gemv_stacked(rn(3, 8), rn(2, 4, 16, 8), 1, s2, 0.3,
                                     2, autotune=True, with_stats=stats)
        ops.pcilt_fused_gemv_paired(rn(3, 8), rn(2, 256, 8), s2, 0.3, 2,
                                    autotune=True, with_stats=stats)
        ops.pcilt_fused_gemv_paired_stacked(rn(3, 8), rn(2, 3, 256, 8), 1,
                                            s2, 0.3, 2, autotune=True,
                                            with_stats=stats)
    ops.pcilt_fused_gemv_plan(rn(3, 8), tabs, torch.arange(
        8, dtype=torch.int32).reshape(4, 2), s2, 0.3, 2, autotune=True)
    ops.pcilt_fused_dwconv1d(rn(2, 6, 5), rn(5, 16), s2, 0.3, 2,
                             autotune=True)
    ops.pcilt_fused_dwconv1d(rn(2, 6, 5), rn(5, 16), s2, 0.3, 2,
                             autotune=True, with_stats=True)
    ops.pcilt_shared_gemv(rn(3, 8), rn(2, 16, 8), ri(2, 4), s2, 0.3, 2,
                          autotune=True)
    ops.pcilt_gemv(ri(16, 3, 4), tabs, autotune=True)
    ops.pcilt_conv2d(ri(16, 1, 3, 3, 4), tabs, autotune=True)
    img = rn(1, 5, 5, 2)
    ops.pcilt_fused_conv2d(img, rn(18, 4, 6), s2, 0.3, 1, 3, 3,
                           autotune=True)
    ops.pcilt_shared_conv2d(img, rn(3, 4, 6), ri(3, 18), s2, 0.3, 1, 3, 3,
                            autotune=True)


def test_a_cache_written_by_tune_design_validates_clean(tune_cache):
    with atn.using_timer(_fake_timer()):
        _tune_every_family()
    with open(tune_cache) as f:
        cache = json.load(f)
    assert schema.validate_design_cache(cache, "tiles.json") == []
    seen = {}
    for key in cache:
        kernel, dims, dtype, backend = schema.parse_design_key(key)
        assert backend == "cpu" and dtype == "float32"
        seen[kernel] = tuple(sorted(dims))
    # every family but the host-packed dwconv's (its CPU path runs the
    # reference's plain version, untuned) tunes on the CPU; each key has
    # exactly the dimensions the schema requires
    assert set(seen) == set(schema.KNOWN_KERNELS) - {"dwconv1d_host"}
    for kernel, dims in seen.items():
        assert dims == tuple(sorted(schema.KNOWN_KERNELS[kernel])), kernel
    assert schema.validate_repo_artifacts(ROOT, cache_path=tune_cache) == []


def test_designs_are_the_wrappers_counted_designs():
    schema.validate_design_cache({})
    assert schema.DESIGNS["fused_gemv_plan"] == ("split", "direct")
    assert schema.DESIGNS["fused_dwconv1d_sat"] == ("tiled", "direct")
    assert schema.DESIGNS["conv2d_host"] == ("staged", "direct")
    assert set(schema.DESIGNS) == set(schema.KNOWN_KERNELS)


GOOD_KEY = atn.shape_key("fused_gemv", dtype=torch.float32, backend=H100,
                         B=4, G=512, V=16, O=3072, g=2, bits=2)
GOOD = {GOOD_KEY: {"design": "split", "us": 24.0, "candidates": 2},
        atn.shape_key("dwconv1d_host", dtype=torch.bfloat16,
                      backend="cpu", B=4, T=2048, C=1792, V=256):
        {"design": "staged", "us": None, "candidates": 1}}


def test_good_cache_validates_clean():
    assert schema.validate_design_cache(GOOD) == []
    kernel, dims, dtype, backend = schema.parse_design_key(GOOD_KEY)
    assert (kernel, dims["O"], dtype, backend) == ("fused_gemv", 3072,
                                                   "float32", H100)


def _with(key, entry=None, **fields):
    bad = copy.deepcopy(GOOD)
    e = dict(bad.pop(GOOD_KEY), **fields) if entry is None else entry
    bad[key] = e
    return bad


@pytest.mark.parametrize("cache,needle", [
    (_with("fused_gemv|B=4,G=512|backend=cpu"), "bad shape key"),
    (_with(GOOD_KEY.replace("backend=cuda:", "backend=tpu:")),
     "bad shape key"),
    (_with(GOOD_KEY.replace("fused_gemv|", "fused_gemm|")),
     "unknown kernel family"),
    (_with(GOOD_KEY.replace("O=3072,", "")), "missing required dims"),
    (_with(GOOD_KEY.replace("B=4", "B=0")), "non-positive dims"),
    (_with(GOOD_KEY.replace("dtype=float32", "dtype=int8")),
     "not a table dtype"),
    (_with(GOOD_KEY, design="staged"), "not one of 'fused_gemv'"),
    (_with(GOOD_KEY, design=3), "'design' must be a string"),
    (_with(GOOD_KEY, us=float("nan")), "finite number"),
    (_with(GOOD_KEY, us="fast"), "finite number"),
    (_with(GOOD_KEY, candidates=-1), "non-negative int"),
    (_with(GOOD_KEY, candidates=0), "candidates=0"),
    (_with(GOOD_KEY, tiles={"Bb": 8}), "unknown fields"),
    (_with(GOOD_KEY, entry={"design": "split", "candidates": 2}),
     "missing 'us'"),
    (_with(GOOD_KEY, entry=["split"]), "entry must be an object"),
    (["not", "a", "map"], "cache root must be an object")])
def test_seeded_cache_corruptions_fire_schema002(cache, needle):
    fs = schema.validate_design_cache(cache, "tiles.json")
    assert fs and {f.rule for f in fs} == {"SCHEMA002"}
    assert any(needle in f.message for f in fs), [f.message for f in fs]


def test_the_environments_cache_and_committed_files_are_read(tmp_path,
                                                            monkeypatch):
    bad = tmp_path / "tiles.json"
    bad.write_text(json.dumps(_with(GOOD_KEY, candidates=0)))
    monkeypatch.setenv("REPRO_PCILT_TUNE_CACHE", str(bad))
    fs = schema.validate_repo_artifacts(ROOT)
    assert [f.rule for f in fs] == ["SCHEMA002"]
    root = tmp_path / "repo"
    root.mkdir()
    (root / "my_tiles.json").write_text("{not json")
    (root / "BENCH_pr99.json").write_text("[]")
    monkeypatch.delenv("REPRO_PCILT_TUNE_CACHE")
    fs = schema.validate_repo_artifacts(str(root))
    assert sorted(f.rule for f in fs) == ["SCHEMA001", "SCHEMA002"]
    assert any("unreadable design cache" in f.message for f in fs)

