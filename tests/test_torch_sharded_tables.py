"""Port parity: tensor-parallel PCILT tables on CPU meshes.

The port's mesh is one process over an explicit device list
(``repro_torch.launch.mesh``); these tests build meshes of ``"cpu"``
devices, D in {2, 4} (3 for the replication fallback), and hold the
sharded routes of ``pcilt_linear`` / ``pcilt_conv2d`` (gather, onehot,
kernel, fused, shared, paired, stacked, paired stacked; the fused and
shared conv with the kernels' ``seg_offset``/``n_total``; the host conv
paths) to the JAX package:

* against its unsharded execution in this process: bit-equal on exact
  grids (small-integer weights, scale 1: every partial sum is an exact
  float32 integer, so no summation order can differ);
* against its own sharded execution: one module-scoped fixture runs the
  JAX package in a subprocess with 8 forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its
  ``make_decode_mesh``, ``shard_map`` and ``psum``) and writes an
  ``.npz``; Gaussian weights there, so float32 within rtol 1e-5 and 1e-5
  of the largest output (the partials are summed in another order), the
  counters exact;
* ``shard_shared_grouped_tables`` byte-equal to the reference's build (the
  reference's is numpy: it runs in this process too);
* the sharding rules, placement, local-shard design-cache keys, and the
  reference's refusals.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_layers as jl
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.nn import module as jmod
from repro_torch.core import lut_layers as tl
from repro_torch.core import pcilt as tp
from repro_torch.core import quantization as tq
from repro_torch.core import serving as ts
from repro_torch.interop import tables_from_jax, to_torch
from repro_torch.kernels import autotune as atn
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.nn import module as tmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)
BITS, GROUP = 2, 2
SPEC_J, SPEC_T = jq.QuantSpec(BITS), tq.QuantSpec(BITS)

#: the JAX package's sharded run, in a process of its own with 8 forced
#: host devices; every input is drawn there from a seed and saved beside
#: the outputs
JAX_SHARDED_RUN = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import (QuantSpec, build_grouped_tables,
                        build_shared_grouped_tables, pcilt_conv2d,
                        pcilt_linear)
from repro.core.pcilt import build_paired_tables, build_paired_stacked_tables
from repro.launch.mesh import make_decode_mesh

assert jax.device_count() >= 8, jax.device_count()
out = {}
rng = np.random.default_rng(24)
G, spec = 2, QuantSpec(2)
x = np.abs(rng.normal(size=(4, 64))).astype(np.float32)
w = rng.normal(size=(64, 48)).astype(np.float32)
wsh = rng.normal(size=(5, G, 48)).astype(np.float32)[
    rng.integers(0, 5, 32)].reshape(64, 48)
s = np.float32(0.37)
out.update(lin_x=x, lin_w=w, lin_wsh=wsh, lin_s=s)
T = build_grouped_tables(jnp.asarray(w), spec, s, G)
ST = build_shared_grouped_tables(jnp.asarray(wsh), spec, s, G)
L = 3
ws = rng.normal(size=(L, 64, 48)).astype(np.float32)
ss = rng.uniform(0.2, 0.5, L).astype(np.float32)
out.update(pair_ws=ws, pair_ss=ss)
T2 = build_paired_tables(jnp.asarray(ws[1]), spec, ss[1], G)
S2 = build_paired_stacked_tables(jnp.asarray(ws), spec, jnp.asarray(ss), G)
stack = jnp.stack([build_grouped_tables(jnp.asarray(ws[l]), spec, ss[l], G)
                   for l in range(L)])
xc = np.abs(rng.normal(size=(2, 9, 9, 8))).astype(np.float32)
fc = rng.normal(size=(5, 5, 8, 24)).astype(np.float32)
fsh = rng.normal(size=(4, G, 24)).astype(np.float32)[
    rng.integers(0, 4, 100)].reshape(5, 5, 8, 24)
sc = np.float32(0.41)
out.update(conv_x=xc, conv_f=fc, conv_fsh=fsh, conv_s=sc)
STc = build_shared_grouped_tables(jnp.asarray(fsh.reshape(200, 24)), spec,
                                  sc, G)
xj = jnp.asarray(x)
for D in (2, 4):
    m = make_decode_mesh(D)
    for path in ("gather", "onehot", "kernel", "fused"):
        out[f"lin_{path}_{D}"] = pcilt_linear(xj, T, spec, s, G, path=path,
                                              mesh=m)
    for path in ("gather", "shared"):
        out[f"lin_shared_{path}_{D}"] = pcilt_linear(xj, ST, spec, s, G,
                                                     path=path, mesh=m)
    (out[f"stats_out_{D}"], out[f"stats_count_{D}"],
     out[f"stats_ratio_{D}"]) = pcilt_linear(xj, T, spec, s, G, path="fused",
                                             mesh=m, return_stats=True)
    for path in ("fused", "gather"):
        out[f"paired_{path}_{D}"] = pcilt_linear(
            xj, T2, spec, ss[1], G, path=path, mesh=m, paired=True)
    out[f"paired_stacked_{D}"] = pcilt_linear(
        xj, S2, spec, ss[1], G, path="fused", mesh=m, stacked=1, paired=True)
    out[f"stacked_{D}"] = pcilt_linear(xj, stack, spec, ss[1], G,
                                       path="fused", mesh=m, stacked=1)
    for path in ("fused", "gather"):
        out[f"conv_{path}_{D}"] = pcilt_conv2d(
            jnp.asarray(xc), jnp.asarray(fc), spec, sc, G, stride=2,
            path=path, mesh=m)
    out[f"conv_shared_{D}"] = pcilt_conv2d(
        jnp.asarray(xc), jnp.asarray(fsh), spec, sc, G, stride=2, tables=STc,
        path="shared", mesh=m)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
'''


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The outputs (and inputs) of the JAX package's own sharded run."""
    d = tmp_path_factory.mktemp("jax_sharded")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["REPRO_PCILT_TUNE_CACHE"] = str(d / "tiles.json")
    r = subprocess.run([sys.executable, "-c", JAX_SHARDED_RUN,
                        str(d / "out.npz")], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"the JAX sharded run failed:\n{r.stderr}"
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module", autouse=True)
def _tune_caches(tmp_path_factory):
    """Private design caches for both packages."""
    from repro.kernels import autotune as jatn

    d = tmp_path_factory.mktemp("tune")
    jatn.reset_cache(str(d / "jax_tiles.json"))
    atn.reset_cache(str(d / "tiles.json"))
    yield
    jatn.reset_cache()
    atn.reset_cache(str(d / "after.json"))


@pytest.fixture
def tune_cache(tmp_path):
    path = str(tmp_path / "tiles.json")
    atn.reset_cache(path)
    atn.TIMING_RUNS = 0
    yield path
    atn.TIMING_RUNS = 0
    atn.reset_cache(str(tmp_path / "after.json"))


def fake_timer():
    """Runs the candidate once and reports a fixed time (the first
    candidate wins)."""
    def timer(fn, reps, warmup):
        fn()
        return 1.0
    return timer


def _mesh(D):
    return tmesh.make_decode_mesh(D, devices=["cpu"] * D)


def _int_weights(n, O):
    return RNG.integers(-4, 5, size=(n, O)).astype(np.float32)


def _codebook_weights(n, O, X):
    cb = RNG.integers(-4, 5, size=(X, GROUP, O)).astype(np.float32)
    return cb[RNG.integers(0, X, n // GROUP)].reshape(n, O)


def _gemv_problem(B=4, n=64, O=48, shared=False):
    """An exact grid: integer weights, scale 1."""
    x = np.abs(RNG.normal(size=(B, n))).astype(np.float32)
    w = _codebook_weights(n, O, 5) if shared else _int_weights(n, O)
    build = jp.build_shared_grouped_tables if shared \
        else jp.build_grouped_tables
    return x, w, build(jnp.asarray(w), SPEC_J, jnp.float32(1.0), GROUP)


def _close(got, want):
    want = np.asarray(want)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# ----------------------------------------------------------------------------
# the mesh, the rules and the placement
# ----------------------------------------------------------------------------


def test_meshes_never_fall_back_to_the_cpu(monkeypatch):
    """Without ``devices=`` a mesh spans CUDA cards: none here, so every
    request raises; with one card, more than one shard raises; with
    ``devices=`` any list of the right length goes, repeats included."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_decode_mesh()
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        tmesh.make_decode_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards, this host "
                                           "has 1"):
        tmesh.make_decode_mesh(4)
    one = tmesh.make_decode_mesh()
    assert one.shape == {"data": 1, "model": 1}
    assert one.axis_devices("model") == [torch.device("cuda", 0)]
    m = tmesh.make_decode_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model") and m.devices.size == 4
    assert m.shape == {"data": 1, "model": 4}
    assert m.axis_devices("model") == [torch.device("cpu")] * 4
    h = tmesh.make_host_mesh(2, 3, devices=["cpu"] * 6)
    assert h.shape == {"data": 2, "model": 3}
    assert len(h.axis_devices("data")) == 2
    with pytest.raises(ValueError, match="takes 4 devices"):
        tmesh.make_decode_mesh(4, devices=["cpu"] * 2)


@pytest.mark.parametrize("G", [64, 12, 18])
def test_table_pspec_matches_reference(G):
    """The rule table and its divisibility fallback, resolved for a model
    axis of 8 (4 and 2) against the reference's own ``ShardingRules``
    (plain dataclasses: no devices needed); the ``seg_axis`` and
    ``mesh_axis`` overrides too."""
    for D in (8, 4, 2):
        sizes = {"data": 1, "model": D}
        jr = jmod.ShardingRules(rules=dict(jmod.DEFAULT_RULES),
                                mesh_axis_sizes=sizes)
        tr = tmod.ShardingRules(rules=dict(tmod.DEFAULT_RULES),
                                mesh_axis_sizes=sizes)
        assert tmod.DEFAULT_RULES == jmod.DEFAULT_RULES
        assert tmod.PCILT_TABLE_AXES == jmod.PCILT_TABLE_AXES
        for kw in ({}, {"ndim": 4, "seg_axis": 1}, {"ndim": 4, "seg_axis": 0},
                   {"mesh_axis": "data"}, {"ndim": 2}):
            assert tmod.pcilt_table_pspec(G, rules=tr, **kw) == tuple(
                jmod.pcilt_table_pspec(G, rules=jr, **kw)), (D, kw)
        for logical, dim in (("batch", 8), ("embed", 6), ("mlp", G),
                             ("layers", 4), (None, 3), ("nope", 4)):
            assert tr.mesh_axes_for(logical, dim) == \
                jr.mesh_axes_for(logical, dim)
    rules = tmod.ShardingRules.for_mesh(_mesh(4))
    assert rules.mesh_axis_sizes == {"data": 1, "model": 4}
    assert tmod.pcilt_table_pspec(64, rules=rules) == ("model", None, None)
    assert tmod.pcilt_table_pspec(18, rules=rules) == (None, None, None)


def test_placement_cuts_and_joins_contiguous_blocks():
    """``pcilt_table_sharding`` gives the shard count and devices;
    ``shard_tensor`` cuts contiguous blocks (views of the table on its own
    device, the leading axis), ``join_shards`` joins them; a fallback
    placement holds one block."""
    m = _mesh(4)
    t = torch.arange(2 * 8 * 3 * 5, dtype=torch.float32).reshape(2, 8, 3, 5)
    p1 = tmod.pcilt_table_sharding(m, 8, ndim=4, seg_axis=1)
    assert (p1.mesh_axis, p1.seg_axis, p1.n_shards) == ("model", 1, 4)
    blocks = tmod.shard_tensor(t, p1)
    assert [b.shape for b in blocks] == [torch.Size([2, 2, 3, 5])] * 4
    assert all(b.is_contiguous() for b in blocks)
    assert torch.equal(tmod.join_shards(blocks, 1), t)
    p0 = tmod.pcilt_table_sharding(m, 8, ndim=3)
    blocks = tmod.shard_tensor(t[0], p0)
    assert all(b.data_ptr() == t[0, 2 * d].data_ptr()
               for d, b in enumerate(blocks))  # views, no copy
    st = tp.ShardedTables.place(t, p1)
    assert st.shape == t.shape and st.n_shards == 4 and st.dim() == 4
    assert st.per_device_bytes() * 4 == t.numel() * 4
    assert torch.equal(st.materialize(), t)
    assert torch.equal(st.layer(1, 0).materialize(), t[1])
    fallback = tmod.pcilt_table_sharding(m, 6)
    assert fallback.n_shards == 1 and fallback.mesh_axis is None
    assert len(tmod.shard_tensor(t[0, :6], fallback)) == 1


# ----------------------------------------------------------------------------
# pcilt_linear: sharded against unsharded, bit for bit on exact grids
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("path", ["gather", "onehot", "kernel", "fused",
                                  "shared"])
def test_gemv_parity_bitwise(D, path):
    """Every path, sharded, bit-equal to the JAX package's unsharded
    gather reference."""
    x, w, T = _gemv_problem(shared=(path == "shared"))
    want = jl.pcilt_linear(jnp.asarray(x), T, SPEC_J, 1.0, GROUP,
                           path="gather")
    got = tl.pcilt_linear(torch.from_numpy(x), tables_from_jax(T, "cpu"),
                          SPEC_T, 1.0, GROUP, path=path, mesh=_mesh(D))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("path", ["gather", "fused", "shared"])
def test_decode_batch1(path):
    """The decode regime proper: B = 1, 4 shards, bit-equal."""
    x, w, T = _gemv_problem(B=1, shared=(path == "shared"))
    want = jl.pcilt_linear(jnp.asarray(x), T, SPEC_J, 1.0, GROUP,
                           path="gather")
    got = tl.pcilt_linear(torch.from_numpy(x), tables_from_jax(T, "cpu"),
                          SPEC_T, 1.0, GROUP, path=path, mesh=_mesh(4))
    assert tuple(got.shape) == (1, want.shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("path", ["gather", "fused", "shared"])
def test_divisibility_fallback(path):
    """G = 16 over a 3-way axis replicates: the unsharded route, bit for
    bit, and the rules say so."""
    x, w, T = _gemv_problem(B=3, n=32, O=24, shared=(path == "shared"))
    m = _mesh(3)
    assert tl.mesh_shard_count(m, "model", 16) == 1
    assert jl.mesh_shard_count(None, "model", 16) == 1
    tt = tables_from_jax(T, "cpu")
    want = tl.pcilt_linear(torch.from_numpy(x), tt, SPEC_T, 1.0, GROUP,
                           path=path)
    got = tl.pcilt_linear(torch.from_numpy(x), tt, SPEC_T, 1.0, GROUP,
                          path=path, mesh=m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", [2, 4])
def test_paired_and_stacked_parity_bitwise(D):
    """Paired ``[G2, V2, O]`` (fused and host-packed), the layer-major
    ``[L, G, V, O]`` stack and the segment-major paired ``[G2, L, V2, O]``
    stack, sharded, bit-equal to the JAX package's unsharded fused
    routes; the odd-G phantom segment (G = 15 -> G2 = 8) is padded before
    the split."""
    L, B, O = 3, 4, 40
    for n in (60, 64):
        ws = RNG.integers(-3, 4, size=(L, n, O)).astype(np.float32)
        x = np.abs(RNG.normal(size=(B, n))).astype(np.float32)
        ones = jnp.ones(L, jnp.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        T2 = jp.build_paired_tables(jnp.asarray(ws[1]), SPEC_J, 1.0, GROUP)
        S2 = jp.build_paired_stacked_tables(jnp.asarray(ws), SPEC_J, ones,
                                            GROUP)
        want = jl.pcilt_linear(jx, T2, SPEC_J, 1.0, GROUP, path="fused",
                               paired=True)
        for path in ("fused", "gather", "kernel"):
            got = tl.pcilt_linear(tx, to_torch(T2), SPEC_T, 1.0, GROUP,
                                  path=path, mesh=_mesh(D), paired=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for path in ("fused", "gather"):
            got = tl.pcilt_linear(tx, to_torch(S2), SPEC_T, 1.0, GROUP,
                                  path=path, mesh=_mesh(D), stacked=1,
                                  paired=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if n == 64:
            stack = jnp.stack([jp.build_grouped_tables(
                jnp.asarray(ws[l]), SPEC_J, 1.0, GROUP) for l in range(L)])
            want = jl.pcilt_linear(jx, stack, SPEC_J, 1.0, GROUP,
                                   path="fused", stacked=2)
            for path in ("fused", "gather", "kernel"):
                got = tl.pcilt_linear(tx, to_torch(stack), SPEC_T, 1.0,
                                      GROUP, path=path, mesh=_mesh(D),
                                      stacked=2)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_stats_count_each_element_once(D):
    """``return_stats`` on a sharded route: one pass over the whole ``x``
    (every shard sees all of it), equal to the unsharded kernel's
    in-kernel counters; the output unchanged."""
    L, n, O = 2, 64, 24
    ws = RNG.integers(-3, 4, size=(L, n, O)).astype(np.float32)
    x = torch.from_numpy(RNG.normal(size=(4, n)).astype(np.float32) * 3)
    stack = torch.stack([tp.build_grouped_tables(torch.from_numpy(ws[l]),
                                                 SPEC_T, 1.0, GROUP)
                         for l in range(L)])
    S2 = tp.build_paired_stacked_tables(torch.from_numpy(ws), SPEC_T,
                                        torch.ones(L), GROUP)
    for tabs, paired in ((stack, False), (S2, True)):
        want = tl.pcilt_linear(x, tabs, SPEC_T, 1.0, GROUP, path="fused",
                               stacked=1, paired=paired, return_stats=True)
        got = tl.pcilt_linear(x, tabs, SPEC_T, 1.0, GROUP, path="fused",
                              stacked=1, paired=paired, return_stats=True,
                              mesh=_mesh(D))
        assert int(want[1]) > 0  # some codes saturate
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


# ----------------------------------------------------------------------------
# against the JAX package's own sharded run (8 forced host devices)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4])
def test_linear_routes_match_jax_sharded(jax_sharded, D):
    """Gaussian weights: every linear route, sharded, against the JAX
    package's sharded execution of the same inputs; the sharded stats
    exact."""
    j = jax_sharded
    x, s = torch.from_numpy(j["lin_x"]), float(j["lin_s"])
    T = tp.build_grouped_tables(torch.from_numpy(j["lin_w"]), SPEC_T, s,
                                GROUP)
    ST = tp.build_shared_grouped_tables(torch.from_numpy(j["lin_wsh"]),
                                        SPEC_T, s, GROUP)
    m = _mesh(D)
    for path in ("gather", "onehot", "kernel", "fused"):
        _close(tl.pcilt_linear(x, T, SPEC_T, s, GROUP, path=path, mesh=m),
               j[f"lin_{path}_{D}"])
    for path in ("gather", "shared"):
        _close(tl.pcilt_linear(x, ST, SPEC_T, s, GROUP, path=path, mesh=m),
               j[f"lin_shared_{path}_{D}"])
    out, count, ratio = tl.pcilt_linear(x, T, SPEC_T, s, GROUP, path="fused",
                                        mesh=m, return_stats=True)
    _close(out, j[f"stats_out_{D}"])
    assert int(count) == int(j[f"stats_count_{D}"])
    np.testing.assert_allclose(float(ratio), float(j[f"stats_ratio_{D}"]),
                               rtol=1e-6)
    ws, ss = torch.from_numpy(j["pair_ws"]), torch.from_numpy(j["pair_ss"])
    s1 = float(ss[1])
    T2 = tp.build_paired_tables(ws[1], SPEC_T, s1, GROUP)
    S2 = tp.build_paired_stacked_tables(ws, SPEC_T, ss, GROUP)
    stack = torch.stack([tp.build_grouped_tables(ws[l], SPEC_T, float(ss[l]),
                                                 GROUP) for l in range(3)])
    for path in ("fused", "gather"):
        _close(tl.pcilt_linear(x, T2, SPEC_T, s1, GROUP, path=path, mesh=m,
                               paired=True), j[f"paired_{path}_{D}"])
    _close(tl.pcilt_linear(x, S2, SPEC_T, s1, GROUP, path="fused", mesh=m,
                           stacked=1, paired=True), j[f"paired_stacked_{D}"])
    _close(tl.pcilt_linear(x, stack, SPEC_T, s1, GROUP, path="fused", mesh=m,
                           stacked=1), j[f"stacked_{D}"])


@pytest.mark.parametrize("D", [2, 4])
def test_conv_routes_match_jax_sharded(jax_sharded, D):
    """The strided SAME conv (5x5 over 8 channels, G = 100): the fused and
    shared conv (in-kernel im2col a shard, ``seg_offset``) and the host
    path, sharded, against the JAX package's sharded run."""
    j = jax_sharded
    x, s = torch.from_numpy(j["conv_x"]), float(j["conv_s"])
    f, fsh = torch.from_numpy(j["conv_f"]), torch.from_numpy(j["conv_fsh"])
    m = _mesh(D)
    for path in ("fused", "gather"):
        _close(tl.pcilt_conv2d(x, f, SPEC_T, s, GROUP, stride=2, path=path,
                               mesh=m), j[f"conv_{path}_{D}"])
    ST = tp.build_shared_grouped_tables(fsh.reshape(200, 24), SPEC_T, s,
                                        GROUP)
    _close(tl.pcilt_conv2d(x, fsh, SPEC_T, s, GROUP, stride=2, tables=ST,
                           path="shared", mesh=m), j[f"conv_shared_{D}"])


# ----------------------------------------------------------------------------
# the conv: in-kernel im2col a shard, seg_offset / n_total
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("path", ["fused", "shared", "gather", "kernel"])
def test_conv2d_sharded_bitwise(D, path):
    """3x3 over 4 channels (G = 18: shards at 2, replicates at 4), integer
    weights and scale 1: bit-equal to the JAX package's gather."""
    B, H, W, C, k, Co = 2, 8, 8, 4, 3, 16
    x = np.abs(RNG.normal(size=(B, H, W, C))).astype(np.float32)
    n = k * k * C
    w = _codebook_weights(n, Co, 4) if path == "shared" else \
        _int_weights(n, Co)
    f = w.reshape(k, k, C, Co)
    want = jl.pcilt_conv2d(jnp.asarray(x), jnp.asarray(f), SPEC_J, 1.0, GROUP,
                           path="gather")
    tables = None
    if path == "shared":
        tables = tp.build_shared_grouped_tables(torch.from_numpy(w), SPEC_T,
                                                1.0, GROUP)
    got = tl.pcilt_conv2d(torch.from_numpy(x), torch.from_numpy(f), SPEC_T,
                          1.0, GROUP, tables=tables, path=path, mesh=_mesh(D))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group,seg_offset,G", [(2, 5, 7), (2, 0, 6),
                                                (3, 4, 4), (1, 30, 5)])
def test_conv_kernels_plain_match_reference_at_seg_offset(group, seg_offset,
                                                          G):
    """Kernels 4 and 5 at a shard: the plain versions with ``seg_offset``
    and ``n_total`` against the JAX package's Pallas kernels (interpret
    mode) on the same shard, the alignment slots of the last shard
    included (3x3 over 5 channels: 45 positions, padded to the group)."""
    B, H, W, C, k, O = 2, 6, 5, 5, 3, 9
    n = k * k * C
    n_total = -(-n // group) * group
    V = 1 << (BITS * group)
    x = np.abs(RNG.normal(size=(B, H, W, C))).astype(np.float32)
    tab = RNG.normal(size=(G, V, O)).astype(np.float32)
    pool = RNG.normal(size=(3, V, O)).astype(np.float32)
    idx = RNG.integers(0, 3, G).astype(np.int32)
    kw = dict(seg_offset=seg_offset, n_total=n_total)
    want = jops.pcilt_fused_conv2d(jnp.asarray(x), jnp.asarray(tab), SPEC_J,
                                   0.3, group, k, k, **kw)
    got = tops.pcilt_fused_conv2d(torch.from_numpy(x), torch.from_numpy(tab),
                                  SPEC_T, 0.3, group, k, k, **kw)
    _close(got, want)
    want = jops.pcilt_shared_conv2d(jnp.asarray(x), jnp.asarray(pool),
                                    jnp.asarray(idx), SPEC_J, 0.3, group, k,
                                    k, stride=2, **kw)
    got = tops.pcilt_shared_conv2d(torch.from_numpy(x),
                                   torch.from_numpy(pool),
                                   torch.from_numpy(idx), SPEC_T, 0.3, group,
                                   k, k, stride=2, **kw)
    _close(got, want)


def test_conv_shard_geometry_and_code_channels():
    """A shard must lie inside the padded patch; the staged pre-pass's
    channel range covers exactly the channels the shard's live positions
    touch, and its plain version is the whole pre-pass's slice."""
    x = torch.rand(1, 6, 6, 5)
    tab = torch.zeros(4, 16, 3)
    with pytest.raises(ValueError, match="outside"):
        tops.pcilt_fused_conv2d(x, tab, SPEC_T, 0.3, 2, 3, 3, seg_offset=20,
                                n_total=46)
    with pytest.raises(ValueError, match="does not cover"):
        tops.pcilt_fused_conv2d(x, tab, SPEC_T, 0.3, 2, 3, 3, n_total=40)
    # 3x3 over C = 5, group 2: positions in [kh, kw, C] order
    assert tops.conv_code_channels(5, 3, 3, 2, 0, 2) == (0, 4)
    assert tops.conv_code_channels(5, 3, 3, 2, 5, 2) == (0, 4)  # 10..13
    assert tops.conv_code_channels(5, 3, 3, 2, 6, 1) == (2, 2)  # 12, 13
    assert tops.conv_code_channels(5, 3, 3, 2, 2, 2) == (0, 5)  # 4..7 wraps
    assert tops.conv_code_channels(5, 3, 3, 2, 22, 1) == (4, 1)  # 44, pad
    assert tops.conv_code_channels(5, 3, 3, 2, 23, 1) == (0, 1)  # none live
    assert tops.conv_code_channels(5, 3, 3, 2, 0, 23) == (0, 5)
    xp = torch.rand(2, 7, 6, 5)
    full = tops.conv_codes_plain(xp, SPEC_T, 0.25)
    assert torch.equal(tops.conv_codes_plain(xp, SPEC_T, 0.25, 2, 2),
                       full[:, 2:4])
    assert torch.equal(tops._conv_codes(xp, SPEC_T, 0.25, 1, 3),
                       full[:, 1:4])


# ----------------------------------------------------------------------------
# sharded shared pools
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_pool_build_matches_reference(D):
    """``shard_shared_grouped_tables`` against the reference's build, byte
    for byte: the stacked local pools, the local pointers, the per-shard
    cardinalities; its memory accounting and ``materialize``."""
    w = _codebook_weights(64, 24, 6)
    st_j = jp.build_shared_grouped_tables(jnp.asarray(w), SPEC_J, 0.5, GROUP)
    st_t = tables_from_jax(st_j, "cpu")
    want = jp.shard_shared_grouped_tables(st_j, D)
    got = tp.shard_shared_grouped_tables(st_t, D)
    assert got.n_shards == D and got.n_segments == 32
    assert got.shard_cards == tuple(int(c) for c in want.shard_cards)
    assert got.max_cardinality == want.max_cardinality
    np.testing.assert_array_equal(torch.stack(got.pools).numpy(),
                                  np.asarray(want.pools))
    np.testing.assert_array_equal(torch.stack(got.seg_idx).numpy(),
                                  np.asarray(want.seg_idx))
    assert all(i.dtype == torch.int32 for i in got.seg_idx)
    assert got.local_pool_bytes() == want.local_pool_bytes()
    np.testing.assert_array_equal(got.materialize().numpy(),
                                  np.asarray(want.materialize()))
    # the JAX pool crosses the bridge as the port's, shard by shard
    crossed = tables_from_jax(want, "cpu", mesh=_mesh(D))
    assert crossed.shard_cards == got.shard_cards
    assert all(torch.equal(a, b) for a, b in zip(crossed.pools, got.pools))


def test_shard_pool_memory_scales_with_local_cardinality():
    """Each half of the layer names half the codebook: local pools of 2
    rows, per-device memory below the global pool's, the tables the
    same."""
    n, O, X = 64, 32, 4
    G = n // GROUP
    cb = RNG.integers(-4, 5, size=(X, GROUP, O)).astype(np.float32)
    picks = np.concatenate([RNG.integers(0, 2, G // 2),
                            RNG.integers(2, 4, G // 2)])
    w = torch.from_numpy(cb[picks].reshape(n, O))
    st = tp.build_shared_grouped_tables(w, SPEC_T, 0.5, GROUP)
    assert st.pool_cardinality == X
    sp = tp.shard_shared_grouped_tables(st, 2)
    assert sp.shard_cards == (2, 2) and sp.max_cardinality == 2
    assert sp.local_pool_bytes() < st.pool_bytes()
    assert torch.equal(sp.materialize(), st.materialize())
    with pytest.raises(ValueError, match="must divide"):
        tp.shard_shared_grouped_tables(st, 3)


def test_shard_pool_refusals_are_the_references():
    """A pool cut 4 ways under a 2-way mesh, without a mesh, or on a dense
    path raises the reference's errors (the JAX package's, beside)."""
    x, w, st_j = _gemv_problem(shared=True)
    sp_j = jp.shard_shared_grouped_tables(st_j, 4)
    sp_t = tp.shard_shared_grouped_tables(tables_from_jax(st_j, "cpu"), 4)
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="built for 4 shards"):
        tl.pcilt_linear(tx, sp_t, SPEC_T, 1.0, GROUP, path="shared",
                        mesh=_mesh(2))
    with pytest.raises(ValueError, match="mesh operand"):
        tl.pcilt_linear(tx, sp_t, SPEC_T, 1.0, GROUP, path="shared")
    with pytest.raises(ValueError, match="mesh operand"):
        jl.pcilt_linear(jnp.asarray(x), sp_j, SPEC_J, 1.0, GROUP,
                        path="shared")
    with pytest.raises(ValueError, match="'shared' or 'gather'"):
        tl.pcilt_linear(tx, sp_t, SPEC_T, 1.0, GROUP, path="fused",
                        mesh=_mesh(4))
    with pytest.raises(ValueError, match="built for 4 shards"):
        tl.pcilt_conv2d(torch.rand(1, 6, 6, 4),
                        torch.zeros(4, 4, 4, 48), SPEC_T, 1.0, GROUP,
                        tables=tp.shard_shared_grouped_tables(
                            tables_from_jax(st_j, "cpu"), 4),
                        path="shared", mesh=_mesh(2))
    got = tl.pcilt_linear(tx, sp_t, SPEC_T, 1.0, GROUP, path="shared",
                          mesh=_mesh(4))
    want = jl.pcilt_linear(jnp.asarray(x), st_j, SPEC_J, 1.0, GROUP,
                           path="gather")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generalized_plan_refuses_to_shard():
    """A SegmentPlan cannot shard along contiguous blocks: plan= with a
    sharding mesh raises the reference's error (on every path); without
    the mesh the plan runs replicated."""
    from repro_torch.core import SegmentPlan

    x = torch.from_numpy(np.abs(RNG.normal(size=(4, 8))).astype(np.float32))
    plan = SegmentPlan(np.array([[1, 0], [3, 2], [5, 4], [7, 6]], np.int32))
    Tp = tp.build_grouped_tables(torch.from_numpy(_int_weights(8, 16)),
                                 SPEC_T, 1.0, GROUP, plan=plan)
    for path in ("gather", "fused"):
        with pytest.raises(ValueError, match="cannot be sharded"):
            tl.pcilt_linear(x, Tp, SPEC_T, 1.0, GROUP, plan=plan, path=path,
                            mesh=_mesh(4))
    out = tl.pcilt_linear(x, Tp, SPEC_T, 1.0, GROUP, plan=plan, path="gather")
    assert tuple(out.shape) == (4, 16)


# ----------------------------------------------------------------------------
# the converted layers under a mesh
# ----------------------------------------------------------------------------


def test_convert_kernel_mesh_places_table_shards():
    """Dense shards placed at conversion (``ShardedTables`` of ``[G/D, V,
    O]`` blocks), per-device bytes a D-th, the integrity record the
    unsharded one's and verified through the shards, every path bit-equal
    to the unsharded layer; a flipped shard entry is caught."""
    n, O, D = 64, 48, 4
    x = torch.from_numpy(np.abs(RNG.normal(size=(2, n))).astype(np.float32))
    w = torch.from_numpy(_int_weights(n, O))
    lin = ts.convert_kernel(w, SPEC_T, 1.0, GROUP, mesh=_mesh(D))
    ref = ts.convert_kernel(w, SPEC_T, 1.0, GROUP)
    assert lin.shard_count == D and isinstance(lin.tables, tp.ShardedTables)
    assert [tuple(s.shape) for s in lin.tables.shards] == [(8, 16, O)] * D
    assert lin.per_device_table_bytes() * D == lin.table_bytes() == \
        ref.table_bytes()
    assert lin.integrity == ref.integrity
    assert all(lin.verify_integrity().values())
    for path in ("gather", "fused", "kernel", "onehot"):
        assert torch.equal(lin(x, path=path), ref(x, path="gather")), path
    lin.tables.shards[2][3, 1, 5] += 1.0
    assert lin.verify_integrity() == {"tables": False}
    # a 3-way mesh replicates: the layer holds the whole tables
    rep = ts.convert_kernel(w, SPEC_T, 1.0, GROUP, mesh=_mesh(3))
    assert rep.shard_count == 1 and torch.is_tensor(rep.tables)
    assert rep.per_device_table_bytes() == rep.table_bytes()


def test_convert_kernel_mesh_shared_pool():
    """A shared layer pre-shards its pool at conversion; per-device bytes
    follow the padded local pool; both shared paths bit-equal to the
    unsharded gather."""
    n, O, D = 64, 32, 4
    x = torch.from_numpy(np.abs(RNG.normal(size=(2, n))).astype(np.float32))
    w = torch.from_numpy(_codebook_weights(n, O, 5))
    ref = ts.convert_kernel(w, SPEC_T, 1.0, GROUP, shared=True)
    lin = ts.convert_kernel(w, SPEC_T, 1.0, GROUP, shared=True,
                            mesh=_mesh(D))
    assert lin.shard_pools is not None and lin.shard_pools.n_shards == D
    assert lin.per_device_table_bytes() == \
        lin.shard_pools.local_pool_bytes() <= lin.table_bytes()
    for path in ("gather", "shared"):
        assert torch.equal(lin(x, path=path), ref(x, path="gather"))


def test_tune_keys_local_shard_shape_no_collision(tune_cache):
    """Tuned at D = 4 and 2, the keys carry the local G (8 and 16), never
    the global 32; a warm cache tunes nothing; the outputs agree."""
    n, O = 64, 48
    x = torch.from_numpy(np.abs(RNG.normal(size=(4, n))).astype(np.float32))
    w = torch.from_numpy(_int_weights(n, O))
    outs = {}
    with atn.using_timer(fake_timer()):
        for D in (4, 2):
            outs[D] = ts.convert_kernel(w, SPEC_T, 1.0, GROUP,
                                        mesh=_mesh(D)).tune(x)
    assert torch.equal(outs[4], outs[2])
    keys = sorted(k for k in json.load(open(tune_cache))
                  if k.startswith("fused_gemv|"))
    assert len(keys) == 2 and any("G=8," in k for k in keys) and \
        any("G=16," in k for k in keys), keys
    assert not any("G=32," in k for k in keys)
    atn.reset_cache(tune_cache)
    atn.TIMING_RUNS = 0
    with atn.using_timer(fake_timer()):
        for D in (4, 2):
            ts.convert_kernel(w, SPEC_T, 1.0, GROUP, mesh=_mesh(D)).tune(x)
    assert atn.TIMING_RUNS == 0


def test_tune_under_mesh_records_null_on_failure(tune_cache):
    """Every candidate failing under a mesh still writes strict JSON, ``us``
    null, under the local-shard key; the layer still runs."""
    def boom(fn, reps, warmup):
        raise RuntimeError("no candidate can run")

    x = torch.from_numpy(np.abs(RNG.normal(size=(4, 64))).astype(np.float32))
    lin = ts.convert_kernel(torch.from_numpy(_int_weights(64, 48)), SPEC_T,
                            1.0, GROUP, mesh=_mesh(4))
    with atn.using_timer(boom):
        out = lin.tune(x)
    assert tuple(out.shape) == (4, 48)
    raw = open(tune_cache).read()
    assert "NaN" not in raw
    entries = json.loads(raw)
    key = next(k for k in entries if k.startswith("fused_gemv|"))
    assert "G=8," in key
    assert entries[key]["us"] is None and entries[key]["candidates"] == 0


def test_conv_layer_tune_keys_local_shard_shape(tune_cache):
    """``PCILTConv2d.tune`` under a mesh records the local shard's key (G
    18 -> 9), ``seg_offset`` not in it: the sharded call is then a pure
    hit (both shards share the key); its output bit-equal to the
    reference's gather."""
    x = np.abs(RNG.normal(size=(2, 8, 8, 4))).astype(np.float32)
    f = _int_weights(36, 8).reshape(3, 3, 4, 8)
    conv = ts.convert_conv_kernel(torch.from_numpy(f), SPEC_T, 1.0, GROUP,
                                  mesh=_mesh(2))
    with atn.using_timer(fake_timer()):
        conv.tune(torch.from_numpy(x))
    keys = [k for k in json.load(open(tune_cache))
            if k.startswith("fused_conv2d|")]
    assert len(keys) == 1 and "G=9," in keys[0], keys
    atn.reset_cache(tune_cache)
    atn.TIMING_RUNS = 0
    with atn.using_timer(fake_timer()):
        got = conv(torch.from_numpy(x), path="fused")
        tops.pcilt_fused_conv2d(torch.from_numpy(x), conv.tables.shards[1],
                                SPEC_T, 1.0, GROUP, 3, 3, seg_offset=9,
                                n_total=36, autotune=True)
    assert atn.TIMING_RUNS == 0, "a shard missed the tuned entry"
    want = jl.pcilt_conv2d(jnp.asarray(x), jnp.asarray(f), SPEC_J, 1.0, GROUP,
                           path="gather")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_layer_shared_mesh_preshards_pool(tune_cache):
    """A shared ``PCILTConv2d`` with a mesh shards and places its pool at
    conversion, keeps per-device memory at the local pool's, tunes the
    local ``shared_conv2d`` key (G 9) and runs bit-equal to the gather."""
    n, Co = 36, 8
    w = _codebook_weights(n, Co, 4)
    f = w.reshape(3, 3, 4, Co)
    x = np.abs(RNG.normal(size=(2, 8, 8, 4))).astype(np.float32)
    conv = ts.convert_conv_kernel(torch.from_numpy(f), SPEC_T, 1.0, GROUP,
                                  shared=True, mesh=_mesh(2))
    assert conv.shard_pools is not None and conv.shard_pools.n_shards == 2
    assert conv.per_device_table_bytes() <= conv.table_bytes()
    with atn.using_timer(fake_timer()):
        got = conv.tune(torch.from_numpy(x))
    keys = [k for k in json.load(open(tune_cache))
            if k.startswith("shared_conv2d|")]
    assert len(keys) == 1 and "G=9," in keys[0], keys
    want = jl.pcilt_conv2d(jnp.asarray(x), jnp.asarray(f), SPEC_J, 1.0, GROUP,
                           path="gather")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(conv(torch.from_numpy(x),
                                       path="gather").numpy(),
                                  np.asarray(want))


def test_sharded_checksums_chain_to_the_unsharded_record():
    """A sharded table's CRC-32 (whole, a layer of a layer-major stack, a
    layer of a segment-major stack, continued) equals the reference's of
    the unsharded bytes; a layout whose bytes are not its shards' back to
    back is refused."""
    m = _mesh(4)
    stack = RNG.normal(size=(3, 8, 16, 5)).astype(np.float32)
    seg_major = RNG.normal(size=(8, 3, 16, 5)).astype(np.float32)
    st = tp.ShardedTables.place(torch.from_numpy(stack),
                                tmod.pcilt_table_sharding(m, 8, ndim=4,
                                                          seg_axis=1))
    sp = tp.ShardedTables.place(torch.from_numpy(seg_major),
                                tmod.pcilt_table_sharding(m, 8, ndim=4))
    assert tp.stacked_checksums(st, 0) == \
        jp.stacked_checksums(jnp.asarray(stack), 0)
    assert tp.stacked_checksums(sp, 1) == \
        jp.stacked_checksums(jnp.asarray(seg_major), 1)
    assert tp.table_checksum(sp) == jp.table_checksum(seg_major)
    assert tp.table_checksum(sp, crc=12345) == \
        tp.table_checksum(torch.from_numpy(seg_major), crc=12345)
    assert tp.layer_checksum(st, 2) == jp.table_checksum(stack[2])
    with pytest.raises(ValueError, match="back to back"):
        tp.table_checksum(st)
