"""Port parity: paired (TL1-style) tables and the paired decode slice.

* ``build_paired_tables`` / ``build_paired_stacked_tables`` equal the JAX
  builds bit for bit (odd and even G, float32 and bfloat16; the stack is
  built in float32 and cast once, as the reference's bundle build does);
* the plain versions of the paired kernels (``ops.pcilt_fused_gemv_paired``
  and ``_paired_stacked``, which run for CPU tensors) against the JAX
  package's Pallas kernels in interpret mode, with and without counters:
  bit-equal on exact grids (small-integer weights, power-of-two scale),
  float32 within rtol = atol = 1e-6 elsewhere (another summation order),
  bfloat16 within 1e-2 (one rounding of the float32 sum), counters exact;
* the paired-vs-unpaired probe (``benchmarks/run.py``'s ``paired_parity``):
  the ``[G, V, O]`` and ``[G2, V2, O]`` layouts bit-equal on the exact grid;
* the segment-major CRC-32 record equal to ``repro.core.serving``'s, and
  ``verify_layer`` localizing one flipped entry to its layer;
* the smoke mamba2 decode on a paired bundle carried across the bridge
  against the JAX ``decode_step`` (rtol = atol = 1e-4, argmax equal but at
  exact ties of the coarse-grid head logits), and
  an ``Engine`` serving a paired bundle giving the JAX engine's tokens.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.core import lut_layers as jl
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.core import serving as js
from repro.kernels import ops as jops
from repro.models import build_model as j_build
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.core import lut_layers as tl
from repro_torch.core import pcilt as tp
from repro_torch.core import quantization as tq
from repro_torch.core import serving as ts
from repro_torch.interop import (bundle_from_jax, params_from_jax, to_numpy,
                                 to_torch)
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model as t_build
from test_torch_donor import hash_free_engines, jax_donor

PAIRED = JPCILT(act_bits=2, group=2)  # the paired decode's configuration


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


def _weights(rng, shape, exact):
    if exact:
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _compare(got, want, dtype, exact):
    got, want = got.float().numpy(), _f32(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------------
# table builds
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group,n,O", [(2, 2, 16, 7), (2, 2, 12, 9),
                                            (4, 1, 6, 130), (2, 3, 15, 4)])
def test_paired_tables_match_reference(bits, group, n, O, dtype):
    """Even and odd G (n = 12 at group 2: G = 6 segments; n = 15 at group 3:
    G = 5, a phantom segment), bit-equal."""
    rng = np.random.default_rng(n * O + bits)
    L = 3
    ws = rng.normal(size=(L, n, O)).astype(np.float32)
    sc = rng.uniform(0.1, 0.4, size=L).astype(np.float32)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jp.build_paired_tables(jnp.asarray(ws[0]), sj, jnp.float32(sc[0]),
                                  group, dtype=jd)
    got = tp.build_paired_tables(torch.from_numpy(ws[0]), st, float(sc[0]),
                                 group, dtype=td)
    assert got.is_contiguous() and got.dtype == td
    assert got.shape == (-(-n // (2 * group)), 1 << (2 * bits * group), O)
    np.testing.assert_array_equal(_f32(to_numpy(got)), _f32(want))
    # the stack: built in float32 and cast once (the bundle build's rule)
    want = jp.build_paired_stacked_tables(jnp.asarray(ws), sj,
                                          jnp.asarray(sc), group).astype(jd)
    got = tp.build_paired_stacked_tables(torch.from_numpy(ws), st,
                                         torch.from_numpy(sc), group,
                                         dtype=td)
    assert got.shape == want.shape and got.dtype == td
    np.testing.assert_array_equal(_f32(to_numpy(got)), _f32(want))


# ----------------------------------------------------------------------------
# the plain versions of the paired kernels against the Pallas kernels
# ----------------------------------------------------------------------------


PAIRED_GEMV = [  # B, G2, group, bits, O, table dtype, exact grid
    (3, 5, 2, 2, 13, "float32", False),
    (4, 6, 2, 2, 130, "float32", False),
    (4, 6, 2, 2, 130, "float32", True),
    (2, 4, 1, 4, 24, "bfloat16", False),
    (1, 3, 2, 2, 129, "float32", False),
]


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("B,G2,group,bits,O,dtype,exact", PAIRED_GEMV)
def test_gemv_paired_plain_matches_reference(B, G2, group, bits, O, dtype,
                                             exact, with_stats):
    rng = np.random.default_rng(B * 100 + G2 * 10 + O)
    n = G2 * 2 * group
    scale = np.float32(0.5 if exact else 0.23)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    tabs = jp.build_paired_tables(jnp.asarray(_weights(rng, (n, O), exact)),
                                  sj, scale, group).astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, n))).astype(np.float32)
    want = jops.pcilt_fused_gemv_paired(jnp.asarray(x), tabs, sj, scale,
                                        group, with_stats=with_stats)
    got = tops.pcilt_fused_gemv_paired(torch.from_numpy(x), to_torch(tabs),
                                       st, float(scale), group,
                                       with_stats=with_stats)
    if with_stats:
        (got, gc, gr), (want, wc, wr) = got, want
        assert gc.dtype == torch.int32 and int(gc) == int(wc) > 0
        assert float(gr) == float(wr)
    assert got.dtype == getattr(torch, dtype)
    _compare(got, want, dtype, exact)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("B,G2,group,bits,O,dtype,exact", PAIRED_GEMV)
def test_gemv_paired_stacked_plain_matches_reference(B, G2, group, bits, O,
                                                     dtype, exact,
                                                     with_stats):
    rng = np.random.default_rng(B * 1000 + G2 * 10 + O)
    L, n = 3, G2 * 2 * group
    scales = np.full(L, 0.5, np.float32) if exact else \
        rng.uniform(0.1, 0.4, size=L).astype(np.float32)
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    tabs = jp.build_paired_stacked_tables(
        jnp.asarray(_weights(rng, (L, n, O), exact)), sj,
        jnp.asarray(scales), group).astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(B, n))).astype(np.float32)
    layer = 1
    want = jops.pcilt_fused_gemv_paired_stacked(
        jnp.asarray(x), tabs, layer, sj, scales[layer], group,
        with_stats=with_stats)
    got = tops.pcilt_fused_gemv_paired_stacked(
        torch.from_numpy(x), to_torch(tabs), layer, st, float(scales[layer]),
        group, with_stats=with_stats)
    if with_stats:
        (got, gc, gr), (want, wc, wr) = got, want
        assert gc.dtype == torch.int32 and int(gc) == int(wc) > 0
        assert float(gr) == float(wr)
    _compare(got, want, dtype, exact)


def test_paired_wrappers_reject_bad_operands():
    spec = tq.QuantSpec(2, True)
    tabs = torch.zeros(3, 2, 256, 4)
    with pytest.raises(ValueError):  # n != G2 * 2 * group
        tops.pcilt_fused_gemv_paired_stacked(torch.zeros(2, 10), tabs, 0,
                                             spec, 1.0, 2)
    with pytest.raises(IndexError):
        tops.pcilt_fused_gemv_paired_stacked(torch.zeros(2, 12), tabs, 2,
                                             spec, 1.0, 2)
    with pytest.raises(ValueError):  # V2 != (2**(bits*group))**2
        tops.pcilt_fused_gemv_paired(torch.zeros(2, 12), torch.zeros(3, 16, 4),
                                     spec, 1.0, 2)
    assert all(v == 0 for v in tops.LAUNCHES.values())


# ----------------------------------------------------------------------------
# pcilt_linear(paired=...) against the reference's, and the parity probe
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [None, 1])
@pytest.mark.parametrize("path", ["gather", "onehot", "kernel", "fused"])
def test_pcilt_linear_paired_matches_reference(path, stacked):
    """Odd G (the phantom segment padded in by the layer), leading dims,
    stats; every path of the port against the same path of the reference."""
    rng = np.random.default_rng(31)
    bits, group, L, G, O = 2, 2, 3, 7, 11  # G odd: G2 = 4
    sj, st = jq.QuantSpec(bits, True), tq.QuantSpec(bits, True)
    scales = rng.uniform(0.2, 0.4, size=L).astype(np.float32)
    ws = rng.normal(size=(L, G * group, O)).astype(np.float32)
    if stacked is None:
        tabs = jp.build_paired_tables(jnp.asarray(ws[0]), sj, scales[0], group)
        s = scales[0]
    else:
        tabs = jp.build_paired_stacked_tables(jnp.asarray(ws), sj,
                                              jnp.asarray(scales), group)
        s = scales[stacked]
    x = (2.0 * rng.normal(size=(2, 3, G * group))).astype(np.float32)
    want, wc, wr = jl.pcilt_linear(jnp.asarray(x), tabs, sj, s, group,
                                   path=path, stacked=stacked, paired=True,
                                   return_stats=True)
    got, gc, gr = tl.pcilt_linear(torch.from_numpy(x), to_torch(tabs), st,
                                  float(s), group, path=path, stacked=stacked,
                                  paired=True, return_stats=True)
    assert got.shape == (2, 3, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert int(gc) == int(wc) and float(gr) == float(wr)


def test_pcilt_linear_paired_refusals():
    """Paired with a shared pool, with ``plan=`` and with ``path='shared'``
    all raise, as in the reference."""
    spec = tq.QuantSpec(2, True)
    x = torch.zeros(2, 8)
    tabs = torch.zeros(2, 256, 4)
    pool = tp.SharedGroupedTables(pool=torch.zeros(1, 16, 4),
                                  seg_idx=torch.zeros(4, dtype=torch.int32),
                                  group=2)
    with pytest.raises(ValueError, match="shared pools"):
        tl.pcilt_linear(x, pool, spec, 1.0, 2, path="gather", paired=True)
    with pytest.raises(ValueError, match="SegmentPlan"):
        tl.pcilt_linear(x, tabs, spec, 1.0, 2, path="fused", paired=True,
                        plan=object())
    with pytest.raises(ValueError, match="no paired variant"):
        tl.pcilt_linear(x, tabs, spec, 1.0, 2, path="shared", paired=True)
    with pytest.raises(ValueError, match="phantom"):
        tl.pcilt_linear(torch.zeros(2, 5), tabs, spec, 1.0, 2, path="fused",
                        paired=True)


@pytest.mark.parametrize("n,O", [(64, 128), (768, 1536)])
def test_paired_parity_probe_is_bit_exact(n, O):
    """``decode_e2e_pr8``'s probe: integer weights, scale 0.5, 2-bit
    symmetric codes; the unpaired fused GEMV on ``[G, V, O]`` and the
    paired one on ``[G2, V2, O]`` agree bit for bit, and with the
    reference's."""
    rng = np.random.default_rng(7)
    spec_j, spec_t = jq.QuantSpec(2, True), tq.QuantSpec(2, True)
    kw = rng.integers(-2, 3, size=(n, O)).astype(np.float32)
    xs = rng.integers(-2, 2, size=(4, n)).astype(np.float32)
    k, x = torch.from_numpy(kw), torch.from_numpy(xs)
    t_u = tp.build_grouped_tables(k, spec_t, 0.5, 2)
    t_p = tp.build_paired_tables(k, spec_t, 0.5, 2)
    out_u = tops.pcilt_fused_gemv(x, t_u, spec_t, 0.5, 2)
    out_p = tops.pcilt_fused_gemv_paired(x, t_p, spec_t, 0.5, 2)
    assert torch.equal(out_u, out_p)
    if n == 64:  # the reference's interpret-mode kernels at the probe size
        jk, jx = jnp.asarray(kw), jnp.asarray(xs)
        want = jops.pcilt_fused_gemv_paired(
            jx, jp.build_paired_tables(jk, spec_j, 0.5, 2), spec_j, 0.5, 2)
        np.testing.assert_array_equal(out_p.numpy(), np.asarray(want))
        want = jops.pcilt_fused_gemv(
            jx, jp.build_grouped_tables(jk, spec_j, 0.5, 2), spec_j, 0.5, 2)
        np.testing.assert_array_equal(out_u.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# integrity of segment-major stacks
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1 << 26, 1000, 3])
def test_segment_major_checksums_match_reference(chunk, monkeypatch):
    """Per-layer CRCs along axis 1, streamed a few segments (or a part of
    one) at a time, equal the reference's whole-slice CRCs."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(5, 3, 16, 7)).astype(np.float32)
    monkeypatch.setattr(tp, "CRC_CHUNK_BYTES", chunk)
    want = jp.stacked_checksums(jnp.asarray(a), axis=1)
    assert tp.stacked_checksums(torch.from_numpy(a), axis=1) == want
    assert tp.stacked_checksums(a, axis=1) == want
    assert [tp.layer_checksum(torch.from_numpy(a), l, 1)
            for l in range(3)] == want
    b = a.astype(ml_dtypes.bfloat16)
    assert tp.stacked_checksums(to_torch(b), axis=1) == \
        jp.stacked_checksums(jnp.asarray(b), axis=1)


@pytest.fixture(scope="module")
def paired_problem():
    """The smoke mamba2 at act_bits=2, group=2 converted paired by the JAX
    package, its parameters and bundle carried across the bridge."""
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"), pcilt=PAIRED,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=2, group=2),
                               dtype=torch.float32)
    jmodel = j_build(jcfg)
    jparams = jax_donor(jmodel.param_specs(), 0)
    calib = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16))
    jdec = js.convert_mamba_decode(jmodel, jparams, jnp.asarray(calib),
                                   paired=True, head="shared")
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "jdec": jdec, "calib": calib,
            "tmodel": t_build(tcfg),
            "tparams": params_from_jax(jax.tree.map(np.asarray, jparams),
                                       "cpu")}


def test_paired_bundle_build_and_record_match_reference(paired_problem):
    """``build_pcilt(paired=True)`` with the reference's scales gives its
    segment-major stacks byte for byte, and the same CRC-32 record."""
    p = paired_problem
    jb = p["jdec"].pcilt
    proj = jb["proj"]
    assert proj["paired"] and proj["tables"]["wz"].shape[1] == \
        p["jcfg"].n_layers
    got = p["tmodel"].build_pcilt(
        p["tparams"], np.asarray(jb["scale"]),
        proj_scales={"in": np.asarray(proj["scales"]["wx"]),
                     "out": np.asarray(proj["scales"]["wo"])},
        head_scale=np.asarray(jb["head"]["scale"]), paired=True)
    assert got["proj"]["paired"]
    for name, t in proj["tables"].items():
        np.testing.assert_array_equal(got["proj"]["tables"][name].numpy(),
                                      np.asarray(t), err_msg=name)
    assert got["integrity"] == jb["integrity"]
    assert ts.pcilt_integrity(bundle_from_jax(jb, "cpu")) == \
        js.pcilt_integrity(jb)


def test_paired_verify_layer_localizes_a_flip(paired_problem):
    p = paired_problem
    bundle = bundle_from_jax(p["jdec"].pcilt, "cpu")
    dec = ts.PCILTMambaDecode(p["tmodel"], bundle)
    assert dec.verify_integrity() == []
    assert dec.table_bytes() == p["jdec"].table_bytes()
    # one entry of layer 1 of the segment-major wo stack [G2, L, V2, O]
    bundle["proj"]["tables"]["wo"][3, 1].view(torch.int32)[17, 5] ^= 1 << 9
    assert dec.verify_layer(0) == [] and dec.verify_layer(1) == [("wo", 1)]
    assert dec.verify_integrity() == [("wo", 1)]
    with pytest.raises(RuntimeError, match="integrity"):
        ts.PCILTMambaDecode(p["tmodel"], bundle)


def test_paired_decode_steps_match_reference(paired_problem):
    """Four decode steps, saturation stats on: logits and state within
    1e-4, argmax equal, counts exact, ratios within 1e-6.  The head's
    logits lie on a coarse grid (4-bit weights, 2-bit activations), so two
    can tie exactly; where float32 rounding then picks the other, the
    reference's choice must be within 1e-4 of the port's maximum (the rule
    of ``tests/test_torch_serve.py``)."""
    p = paired_problem
    B = 3
    tdec = ts.PCILTMambaDecode(p["tmodel"],
                               bundle_from_jax(p["jdec"].pcilt, "cpu"))
    rng = np.random.default_rng(13)
    specs = p["tmodel"].cache_specs(B)["layers"]
    layers = {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
              for k, s in specs.items()}
    jcache = {"layers": {k: jnp.asarray(v) for k, v in layers.items()},
              "pos": jnp.asarray(16, jnp.int32)}
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in layers.items()}}
    tok = rng.integers(0, p["jcfg"].vocab, (B, 1))
    for _ in range(4):
        wl, jcache, wsat = p["jdec"].step(p["jparams"], jcache,
                                          jnp.asarray(tok, jnp.int32),
                                          with_stats=True)
        tops.reset_launches()
        gl, tcache, gsat = tdec.step(p["tparams"], tcache,
                                     torch.from_numpy(tok), with_stats=True)
        assert not any(tops.LAUNCHES.values())  # plain versions on the CPU
        got, want = gl.numpy(), np.asarray(wl)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
            # only at a tie of the coarse-grid head logits
            assert got[b, want[b].argmax()] >= got[b].max() - 1e-4
        for k in ("conv", "ssd"):
            np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                       np.asarray(jcache["layers"][k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        for g in ("in", "conv", "out"):
            np.testing.assert_array_equal(gsat[g]["count"].numpy(),
                                          np.asarray(wsat[g]["count"]))
            np.testing.assert_allclose(gsat[g]["ratio"].numpy(),
                                       np.asarray(wsat[g]["ratio"]),
                                       rtol=1e-6)
        tok = np.array(jnp.argmax(wl, -1))[:, None]


def test_paired_matches_unpaired_on_the_port(paired_problem):
    """The port's own paired decode against its unpaired decode on the same
    scales: the paired fetch adds the same table entries, two at a time."""
    p = paired_problem
    jb = p["jdec"].pcilt
    proj = jb["proj"]
    kw = dict(proj_scales={"in": np.asarray(proj["scales"]["wx"]),
                           "out": np.asarray(proj["scales"]["wo"])})
    paired = p["tmodel"].build_pcilt(p["tparams"], np.asarray(jb["scale"]),
                                     paired=True, **kw)
    unpaired = p["tmodel"].build_pcilt(p["tparams"], np.asarray(jb["scale"]),
                                       **kw)
    cache = {"layers": {k: torch.zeros(s.shape) for k, s in
                        p["tmodel"].cache_specs(2)["layers"].items()}}
    tok = torch.tensor([[5], [17]])
    a, _ = p["tmodel"].decode_step(p["tparams"], cache, tok, pcilt=paired)
    b, _ = p["tmodel"].decode_step(p["tparams"], cache, tok, pcilt=unpaired)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_engine_serves_paired_bundle_like_reference(paired_problem):
    """The JAX ``Engine`` and the port's serve the same requests from the
    same paired bundle (``pcilt_bundle=``): the same tokens.  A greedy
    token may differ only at an exact tie of the coarse-grid head logits
    (the check of ``test_torch_serve.py``), and the reference's token is
    fed on to both."""
    from repro.launch.serve import Engine as JEngine
    from repro.launch.serve import _make_requests
    from repro_torch.launch.serve import Engine as TEngine
    from repro_torch.launch.serve import make_requests

    p = paired_problem
    with hash_free_engines():  # the donor's weights, not hash()'s
        jeng = JEngine(p["jcfg"], max_len=256, slots=2, pcilt=True,
                       pcilt_bundle=p["jdec"].pcilt)
    jeng.monitor.on_tick = lambda tick, sat=None, rows=1: []
    log = []
    raw = jeng._raw_step

    def logged():
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits)))
        return logits, cache

    jeng._raw_step = logged
    jreqs = _make_requests(p["jcfg"], 2, 4, None, 1)
    jstats = jeng.run(jreqs)
    assert jstats["served"] == 2

    teng = TEngine(p["tcfg"], slots=2, pcilt=True, device="cpu",
                   params=params_from_jax(jax.tree.map(np.asarray,
                                                       jeng.params), "cpu"),
                   pcilt_bundle=bundle_from_jax(p["jdec"].pcilt, "cpu"))
    steps = {"n": 0}
    traw = teng._raw_step

    def compared():
        fed, want = log[steps["n"]]
        np.testing.assert_array_equal(teng.tokens, fed)
        logits, cache = traw()
        got = logits.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for b in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
            assert got[b, want[b].argmax()] >= got[b].max() - 1e-5
        steps["n"] += 1
        return torch.from_numpy(want.copy()), cache

    teng._raw_step = compared
    reqs = make_requests(p["tcfg"], 2, 4, 1)
    stats = teng.run(reqs)
    assert steps["n"] == len(log)
    assert stats["served"] == 2
    assert [r.out for r in reqs] == [q.out for q in jreqs]
    assert stats["table_bytes"] == jstats["table_bytes"]
