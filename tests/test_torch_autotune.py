"""The port's design cache (``repro_torch.kernels.autotune``) against the
reference autotuner's contracts (``tests/test_autotune.py``), wherever they
apply to designs rather than tilings.

On the CPU every design is the kernel's plain version, so these tests time
the plain versions with an injected fake clock (``autotune.using_timer``):
what they check is the cache's contract — a miss tunes once, a hit times
nothing, keys round-trip and stay apart across backends, saves merge only
their own keys, ``us`` is ``null`` and never ``NaN``, a corrupt file is
quarantined (the newest three kept) — and the in-process memo.  The
reference's tiling-space contracts (scratch bounds, bounded sweeps) have no
counterpart: a design has no tiles.  Outputs are held to the reference's
plain versions at 1e-5 (float32 sums in another order).
"""

import itertools
import json
import logging
import os

import numpy as np
import pytest
import torch

from repro_torch.core import QuantSpec, build_grouped_tables, calibrate
from repro_torch.kernels import autotune as atn
from repro_torch.kernels import ops, ref
from repro_torch.runtime import FaultInjector

RNG = np.random.default_rng(7)
H100 = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture
def tune_cache(tmp_path):
    """A private cache file; the memo and the timing count start empty."""
    path = str(tmp_path / "tiles.json")
    atn.reset_cache(path)
    atn.TIMING_RUNS = 0
    yield path
    atn.TIMING_RUNS = 0
    atn.reset_cache(str(tmp_path / "after.json"))


def fake_timer(times=(5.0, 3.0, 4.0)):
    """A clock that runs the candidate once and reports the next of
    ``times`` microseconds (the second candidate wins by default)."""
    it = itertools.cycle(times)

    def timer(fn, reps, warmup):
        fn()
        return next(it)

    return timer


def _problem(B=8, n=64, O=256, bits=2, group=2):
    spec = QuantSpec(bits)
    x = torch.from_numpy(RNG.uniform(0, 3, (B, n)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(n, O)).astype(np.float32))
    s = calibrate(x, spec)
    return x, build_grouped_tables(w, spec, s, group), spec, float(s), group


def _key(x, T, spec, group, backend="cpu"):
    G, V, O = T.shape
    return atn.shape_key("fused_gemv", dtype=T.dtype, backend=backend,
                         B=x.shape[0], G=G, V=V, O=O, g=group,
                         bits=spec.bits)


def test_miss_tunes_then_hit_is_free(tune_cache):
    x, T, spec, s, group = _problem()
    with atn.using_timer(fake_timer()):
        out1 = ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert atn.TIMING_RUNS > 0, "a miss must time its candidates"
    entry = json.load(open(tune_cache))[_key(x, T, spec, group)]
    # kernel 9's candidates at B 8, V 16: split, staged, direct; the
    # fake clock's second wins
    assert entry == {"design": "staged", "us": 3.0, "candidates": 3}

    atn.reset_cache(tune_cache)  # a second process on the same file
    atn.TIMING_RUNS = 0
    with atn.using_timer(fake_timer()):
        out2 = ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert atn.TIMING_RUNS == 0, "a warm cache must time nothing"
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    want = ops.fused_gemv_plain(x, T, spec, s, group)
    torch.testing.assert_close(out1, want, rtol=1e-5, atol=1e-5)


def test_round_trip_returns_same_design(tune_cache):
    x, T, spec, s, group = _problem()
    key = _key(x, T, spec, group)
    with atn.using_timer(fake_timer((2.0, 9.0))):
        ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    first = atn.lookup_design(key)
    assert first == "split"
    atn.reset_cache(tune_cache)
    assert atn.lookup_design(key) == first


def test_lookup_only_dispatch_never_times(tune_cache):
    """Without ``autotune=True`` a miss takes the heuristic silently, and
    with it but no timer the CPU only looks up."""
    x, T, spec, s, group = _problem()
    ops.pcilt_fused_gemv(x, T, spec, s, group)
    ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert atn.TIMING_RUNS == 0
    assert not os.path.exists(tune_cache)


def test_ambient_env_turns_tuning_on(tune_cache, monkeypatch):
    x, T, spec, s, group = _problem()
    monkeypatch.setenv("REPRO_PCILT_AUTOTUNE", "1")
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv(x, T, spec, s, group)
    assert atn.TIMING_RUNS > 0
    assert atn.autotune_enabled(False) is False
    monkeypatch.setenv("REPRO_PCILT_AUTOTUNE", "0")
    assert atn.autotune_enabled() is False


def test_host_kernels_route_through_cache(tune_cache):
    """The host-packed GEMV and conv tune too, and stay right."""
    off = torch.from_numpy(RNG.integers(0, 16, (8, 12)).astype(np.int32))
    tab = torch.from_numpy(RNG.normal(size=(12, 16, 40)).astype(np.float32))
    with atn.using_timer(fake_timer()):
        got = ops.pcilt_gemv(off, tab, autotune=True)
    assert atn.TIMING_RUNS > 0
    torch.testing.assert_close(got, ref.pcilt_gemv_ref(off, tab), rtol=1e-5,
                               atol=1e-5)
    runs = atn.TIMING_RUNS
    offc = torch.from_numpy(RNG.integers(0, 8, (1, 6, 6, 3)).astype(np.int32))
    tabc = torch.from_numpy(RNG.normal(size=(3, 8, 20)).astype(np.float32))
    with atn.using_timer(fake_timer()):
        gotc = ops.pcilt_conv2d(offc, tabc, autotune=True)
    assert atn.TIMING_RUNS > runs
    torch.testing.assert_close(gotc, ref.pcilt_conv2d_ref(offc, tabc),
                               rtol=1e-5, atol=1e-5)
    keys = json.load(open(tune_cache))
    assert any(k.startswith("gemv_host|B=8,G=12,O=40,V=16,") for k in keys)
    assert any(k.startswith("conv2d_host|B=1,G=3,Ho=6,O=20,V=8,Wo=6,")
               for k in keys)
    atn.TIMING_RUNS = 0
    with atn.using_timer(fake_timer()):
        ops.pcilt_gemv(off, tab, autotune=True)
        ops.pcilt_conv2d(offc, tabc, autotune=True)
    assert atn.TIMING_RUNS == 0


def test_counted_launches_tune_under_their_own_family(tune_cache):
    """A counter-carrying launch records under the ``_sat`` family, apart
    from the uncounted one (the reference's rule)."""
    x, T, spec, s, group = _problem(B=4)
    T4 = T[None].contiguous()
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv_stacked(x, T4, 0, spec, s, group,
                                     autotune=True)
        ops.pcilt_fused_gemv_stacked(x, T4, 0, spec, s, group, autotune=True,
                                     with_stats=True)
    kinds = sorted(k.split("|")[0] for k in json.load(open(tune_cache)))
    assert kinds == ["fused_gemv_stacked", "fused_gemv_stacked_sat"]
    assert all("R=4" in k and "L=1" in k for k in json.load(open(tune_cache)))


def test_serving_tune_populates_cache(tune_cache):
    from repro_torch.core.serving import convert_kernel

    spec = QuantSpec(2)
    x = torch.from_numpy(RNG.uniform(0, 1, (4, 24)).astype(np.float32))
    k = torch.from_numpy(RNG.normal(size=(24, 32)).astype(np.float32))
    lin = convert_kernel(k, spec, calibrate(x, spec), group=2)
    want = lin(x, path="gather")
    with atn.using_timer(fake_timer()):
        got = lin.tune(x)
    assert atn.TIMING_RUNS > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    atn.TIMING_RUNS = 0
    torch.testing.assert_close(lin(x, path="fused"), want, rtol=1e-4,
                               atol=1e-4)
    assert atn.TIMING_RUNS == 0


def test_concurrent_saves_keep_newest_per_key(tune_cache):
    """A save merges back only the keys its process recorded: B's newer
    "a" survives A's later save of "b" ("last writer wins per key")."""
    seed = atn.DesignCache(tune_cache)
    seed.record("a", "direct", 5.0, 1)
    cache_a = atn.DesignCache(tune_cache)
    cache_b = atn.DesignCache(tune_cache)
    cache_b.record("a", "split", 3.0, 2)
    cache_a.record("b", "staged", 7.0, 1)
    final = atn.DesignCache(tune_cache)
    assert final.lookup("a") == "split", "a stale copy clobbered the newer"
    assert final.lookup("b") == "staged"


def test_failed_tune_records_null_not_nan(tune_cache):
    """Every candidate failing records the first, untimed: valid JSON."""
    def bench(design):
        raise RuntimeError("no design can run")

    got = atn.tune_design("k|dtype=float32|backend=cpu", ["split", "direct"],
                          bench, timer=fake_timer())
    assert got == "split"
    raw = open(tune_cache).read()
    assert "NaN" not in raw
    entry = json.loads(raw)["k|dtype=float32|backend=cpu"]
    assert entry["us"] is None and entry["candidates"] == 0
    atn.reset_cache(tune_cache)
    assert atn.lookup_design("k|dtype=float32|backend=cpu") == "split"


def test_single_candidate_is_recorded_untimed(tune_cache):
    """Where the guard admits one design it is recorded untimed."""
    got = atn.tune_design("one|dtype=float32|backend=cpu", ["direct"],
                          lambda d: pytest.fail("timed"), timer=fake_timer())
    assert got == "direct" and atn.TIMING_RUNS == 0
    entry = json.load(open(tune_cache))["one|dtype=float32|backend=cpu"]
    assert entry == {"design": "direct", "us": None, "candidates": 1}


def test_record_sanitizes_nonfinite_us(tune_cache):
    atn.get_cache().record("k2", "split", float("nan"), 1)
    assert json.load(open(tune_cache))["k2"]["us"] is None


def test_legacy_nan_cache_file_does_not_break_record(tune_cache):
    with open(tune_cache, "w") as f:
        json.dump({"legacy": {"design": "split", "us": float("nan"),
                              "candidates": 1}}, f)
    cache = atn.DesignCache(tune_cache)
    cache.record("fresh", "direct", 4.2, 1)
    raw = open(tune_cache).read()
    assert "NaN" not in raw
    entries = json.loads(raw)
    assert entries["legacy"]["us"] is None and entries["fresh"]["us"] == 4.2
    assert atn.DesignCache(tune_cache).lookup("legacy") == "split"


@pytest.mark.parametrize("bad", [{"design": 3}, {"us": 1.0}, "split", None])
def test_malformed_entry_is_a_miss(tune_cache, bad):
    with open(tune_cache, "w") as f:
        json.dump({"k": bad}, f)
    assert atn.DesignCache(tune_cache).lookup("k") is None


def test_design_candidates_follow_the_guards():
    """The admitted designs, the heuristic's first (``kernels.ops``)."""
    assert ops.gemv_candidates(4, 768, 1536, 4) == ["split", "direct"]
    assert ops.gemv_candidates(64, 4096, 1536, 4) == ["split"]  # 1 MiB offs
    assert ops.shared_gemv_candidates(4, 768, 50288, 4) == ["split", "direct"]
    assert ops.dwconv_candidates(4) == ["tiled", "direct"]
    assert ops.dwconv_candidates(9) == ["direct"]
    assert ops.conv_candidates(16, 4) == ["staged", "direct"]
    assert ops.conv_candidates(1024, 4) == ["direct"]
    assert ops.gemv_host_candidates(4, 512, 16, 3072, 4) == [
        "split", "staged", "direct"]
    assert ops.gemv_host_candidates(4, 512, 1024, 3072, 4) == ["split",
                                                              "direct"]
    assert ops.gemv_host_candidates(4096, 512, 16, 3072, 4) == [
        "staged", "split", "direct"]
    assert ops.gemv_host_candidates(4096, 512, 1024, 3072, 4) == ["direct",
                                                                 "split"]
    assert ops.dwconv_host_candidates(256, 4) == ["staged", "direct"]
    assert ops.dwconv_host_candidates(65536, 4) == ["direct"]


def test_recorded_design_outside_the_guard_is_ignored(tune_cache):
    """A hand-edited entry naming a design the shape's guard rejects
    dispatches the heuristic instead."""
    dims = dict(B=1, T=1, C=8, V=1 << 18, k=9, bits=2)
    key = atn.shape_key("fused_dwconv1d", dtype=torch.float32,
                        backend="cpu", **dims)
    atn.get_cache().record(key, "tiled", 1.0, 2)
    got = ops._choose(("fused_dwconv1d", tuple(dims), tuple(dims.values())),
                      torch.device("cpu"), torch.float32,
                      lambda: ops.dwconv_candidates(9),
                      lambda d: pytest.fail("timed"), None)
    assert got == "direct"


@pytest.mark.parametrize("other", ["cpu", H100, "cuda:NVIDIA A100-SXM4-80GB"])
def test_backends_never_share_a_key(tune_cache, other):
    """A key recorded on the CPU is never a hit for a card, nor one card's
    for another's."""
    x, T, spec, s, group = _problem()
    assert atn.backend_name(torch.device("cpu")) == "cpu"
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert (atn.lookup_design(_key(x, T, spec, group, other)) is not None) \
        == (other == "cpu")
    atn.get_cache().record(_key(x, T, spec, group, H100), "split", 1.0, 2)
    assert atn.lookup_design(_key(x, T, spec, group, "cpu")) == "staged"
    assert atn.lookup_design(_key(x, T, spec, group, H100)) == "split"


def test_memoised_hit_is_one_dict_lookup(tune_cache, monkeypatch):
    """After the first dispatch of a shape the memo answers without the
    cache; ``reset_cache`` empties it."""
    x, T, spec, s, group = _problem()
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert len(atn.MEMO) == 1
    (mkey, (design, hit)), = atn.MEMO.items()
    assert mkey[0] == "fused_gemv" and design == "staged" and hit

    def no_lookup(key):
        raise AssertionError("the memo should have answered")

    monkeypatch.setattr(atn, "lookup_design", no_lookup)
    ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    monkeypatch.undo()
    atn.reset_cache(tune_cache)
    assert atn.MEMO == {}


def test_dwconv_and_shared_kernels_tune(tune_cache):
    """The fused dwconv and the shared-pool GEMV key as the reference's
    (``T`` the output length; ``X`` the pool cardinality)."""
    from repro_torch.core import build_shared_grouped_tables

    spec = QuantSpec(2)
    x = torch.from_numpy(RNG.uniform(-1, 1, (2, 5, 8)).astype(np.float32))
    tabs = torch.from_numpy(RNG.normal(size=(8, 1 << 8)).astype(np.float32))
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_dwconv1d(x, tabs, spec, 0.5, 4, autotune=True)
        xs = torch.from_numpy(RNG.uniform(0, 1, (4, 16)).astype(np.float32))
        w = torch.from_numpy(RNG.integers(-1, 2, (16, 24)).astype(np.float32))
        pool = build_shared_grouped_tables(w, spec, 0.3, 2)
        got = ops.pcilt_shared_gemv(xs, pool.pool, pool.seg_idx, spec, 0.3, 2,
                                    autotune=True)
    keys = json.load(open(tune_cache))
    assert any(k.startswith("fused_dwconv1d|B=2,C=8,T=5,V=256,bits=2,k=4,")
               for k in keys)
    assert any(k.startswith("shared_gemv|") and f"X={pool.pool.shape[0]},"
               in k for k in keys)
    torch.testing.assert_close(
        got, ops.shared_gemv_plain(xs, pool.pool, pool.seg_idx, spec, 0.3, 2),
        rtol=1e-5, atol=1e-5)


def _quarantined(path):
    d, base = os.path.dirname(path), os.path.basename(path) + ".corrupt-"
    names = [n for n in os.listdir(d) if n.startswith(base)]
    return [os.path.join(d, n)
            for n in sorted(names, key=lambda n: int(n[len(base):]))]


def test_corrupt_cache_warns_quarantines_and_recovers(tune_cache, caplog):
    x, T, spec, s, group = _problem()
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    FaultInjector().garble_file(tune_cache, "truncate")
    garbled = open(tune_cache, "rb").read()
    with caplog.at_level(logging.WARNING, logger="repro_torch.autotune"):
        cache = atn.reset_cache(tune_cache)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "repro_torch.autotune"]
    assert any(tune_cache in m and "corrupt" in m for m in msgs), msgs
    qfiles = _quarantined(tune_cache)
    assert len(qfiles) == 1
    assert open(qfiles[0], "rb").read() == garbled
    assert not os.path.exists(tune_cache)
    atn.TIMING_RUNS = 0
    with atn.using_timer(fake_timer()):
        ops.pcilt_fused_gemv(x, T, spec, s, group, autotune=True)
    assert atn.TIMING_RUNS > 0  # the entry went with the corrupt file
    assert cache.lookup(next(iter(json.load(open(tune_cache))))) is not None


def test_quarantine_distinct_files_and_keeps_newest_three(tune_cache):
    incidents = []
    for i in range(5):
        payload = b"not json at all #%d" % i
        with open(tune_cache, "wb") as f:
            f.write(payload)
        atn.reset_cache(tune_cache)
        qfiles = _quarantined(tune_cache)
        assert open(qfiles[-1], "rb").read() == payload
        incidents.append(qfiles[-1])
        assert not os.path.exists(tune_cache)
    assert len(set(incidents)) == 5
    assert _quarantined(tune_cache) == incidents[-3:]
    assert atn.QUARANTINE_KEEP == 3


def test_mamba_decode_tune_on_the_cpu_looks_up(tune_cache):
    """``PCILTMambaDecode.tune(batch=(1, 2))`` on CPU tensors: the keys of
    both batches, counted and not, are consulted and nothing is timed;
    with a timer each is recorded."""
    import dataclasses

    from repro_torch.configs import PCILTConfig, get_smoke_config
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.models import build_model
    from repro_torch.nn.module import materialize

    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              pcilt=PCILTConfig(act_bits=2, group=2),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, device="cpu")
    calib = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    dec = convert_mamba_decode(model, params, calib, device="cpu")
    dec.tune(batch=(1, 2))
    assert atn.TIMING_RUNS == 0 and not os.path.exists(tune_cache)
    with atn.using_timer(fake_timer()):
        dec.tune(batch=(1, 2))
    # per batch: the dwconv and the projections, with and without counters
    got = {(k.split("|")[0], "B=1," in k) for k in json.load(open(tune_cache))}
    assert got == {(f"{fam}{sat}", b1) for fam in ("fused_dwconv1d",
                                                   "fused_gemv_stacked")
                   for sat in ("", "_sat") for b1 in (True, False)}
