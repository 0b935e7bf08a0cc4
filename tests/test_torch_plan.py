"""Port parity: generalized SegmentPlans, custom convolution functions and
scalar shared tables (the paper's extensions 1-3 beyond contiguous
segments), against the JAX package on the same numpy inputs.

Tolerances: plans, offsets, pointers (``seg_idx``, ``w_idx``), pool order
and every table built with ``mul_fn`` on an exact grid (small-integer
weights, scale 0.5) are compared for equality; other ``mul_fn`` tables
within rtol = atol = 1e-6 (the einsum sums in another order);
``log_mul_fn`` tables within 1e-6 (``log1p`` of two libraries); layer
outputs within rtol = atol = 1e-5 (float32 sums over segments in another
order), and bit-equal on the exact grid.  The fused plan route's plain
version is held to ``repro.kernels.ops.pcilt_fused_gemv_plan``, which runs
the Pallas kernel in interpret mode on the CPU.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro.core import lut_layers as jl
from repro.core import offsets as jo
from repro.core import pcilt as jp
from repro.core import quantization as jq
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch.core import lut_layers as tl
from repro_torch.core import offsets as to
from repro_torch.core import pcilt as tp
from repro_torch.core import quantization as tq
from repro_torch.interop import tables_from_jax, to_torch
from repro_torch.kernels import ops as tops


@pytest.fixture(scope="module", autouse=True)
def _tune_cache(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    yield
    atn.reset_cache()


#: the reference's Fig. 7 plan (tests/test_core_pcilt.py): non-adjacent,
#: reused and skipped positions over n = 8
FIG7 = np.array([[0, 3], [5, 5], [-1, 7]], np.int32)


def _random_plan(rng, n, G, group, skips=2):
    idx = rng.integers(0, n, size=(G, group)).astype(np.int32)
    flat = idx.reshape(-1)
    flat[rng.choice(flat.size, size=skips, replace=False)] = -1
    return idx


PLANS = {
    "fig7": (8, FIG7),
    "contiguous": (12, np.arange(12, dtype=np.int32).reshape(6, 2)),
    # n != G*group, odd G, reused and skipped positions
    "random": (20, _random_plan(np.random.default_rng(3), 20, 7, 2)),
    "group3": (10, _random_plan(np.random.default_rng(4), 10, 5, 3)),
}


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _weights(rng, shape, exact):
    return (rng.integers(-3, 4, size=shape) if exact
            else rng.normal(size=shape)).astype(np.float32)


def _specs(bits, symmetric=False):
    return jq.QuantSpec(bits, symmetric), tq.QuantSpec(bits, symmetric)


# ----------------------------------------------------------------------------
# SegmentPlan
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
def test_segment_plan_gathers_and_packs_as_the_reference(name):
    n, idx = PLANS[name]
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=(3, n)).astype(np.uint8)
    w = rng.normal(size=(n, 5)).astype(np.float32)
    jplan, tplan = jo.SegmentPlan(idx), to.SegmentPlan(idx)
    assert (tplan.n_segments, tplan.group) == (jplan.n_segments, jplan.group)
    np.testing.assert_array_equal(
        tplan.gather_codes(torch.from_numpy(codes)).numpy(),
        np.asarray(jplan.gather_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        tplan.gather_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jplan.gather_weights(jnp.asarray(w))))
    got = tplan.pack(torch.from_numpy(codes), 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jplan.pack(jnp.asarray(codes), 2)))


def test_segment_plan_contiguous_and_validation():
    np.testing.assert_array_equal(to.SegmentPlan.contiguous(8, 2).index,
                                  jo.SegmentPlan.contiguous(8, 2).index)
    with pytest.raises(ValueError):
        to.SegmentPlan.contiguous(7, 2)
    with pytest.raises(ValueError, match=">= -1"):
        to.SegmentPlan(np.array([[0, -2]]))
    with pytest.raises(ValueError):
        to.SegmentPlan(np.arange(4))
    with pytest.raises(ValueError, match="position 7"):
        to.SegmentPlan(FIG7).pack(torch.zeros(2, 7, dtype=torch.uint8), 2)
    assert to.SegmentPlan(FIG7).index.dtype == np.int32


# ----------------------------------------------------------------------------
# table builds: plan=, fn=, scalar and shared tables
# ----------------------------------------------------------------------------


FNS = {"mul": (jp.mul_fn, tp.mul_fn), "log_mul": (jp.log_mul_fn,
                                                  tp.log_mul_fn)}


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("name,exact", [("fig7", True), ("random", False),
                                        ("group3", False), (None, False)])
def test_grouped_tables_with_plan_and_fn_match(name, exact, fn, monkeypatch):
    n, idx = PLANS[name] if name else (12, None)
    group = idx.shape[1] if name else 3
    rng = np.random.default_rng(n + len(fn))
    w = _weights(rng, (n, 6), exact)
    scale = np.float32(0.5 if exact else 0.173)
    sj, st = _specs(2, True)
    jfn, tfn = FNS[fn]
    want = np.asarray(jp.build_grouped_tables(
        jnp.asarray(w), sj, jnp.float32(scale), group,
        plan=None if idx is None else jo.SegmentPlan(idx), fn=jfn))
    # a temporary of a few elements: the custom-fn build runs in many steps
    monkeypatch.setattr(tp, "FN_BUILD_ELEMS", 40)
    got = tp.build_grouped_tables(
        torch.from_numpy(w), st, float(scale), group,
        plan=None if idx is None else to.SegmentPlan(idx), fn=tfn)
    assert got.is_contiguous() and got.shape == want.shape
    if exact and fn == "mul":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("exact", [True, False])
def test_shared_grouped_tables_with_plan_and_fn_match(exact, fn):
    rng = np.random.default_rng(6)
    # 4 distinct [2, out] blocks, repeated: the plan's segments dedupe
    blocks = _weights(rng, (4, 2, 7), exact)
    w = blocks[rng.integers(0, 4, size=10)].reshape(20, 7)
    idx = np.arange(20, dtype=np.int32).reshape(10, 2)[::-1].copy()
    idx[3] = [-1, 5]  # a skipped slot makes a new block
    scale = np.float32(0.5 if exact else 0.173)
    sj, st = _specs(4, True)
    jfn, tfn = FNS[fn]
    want = jp.build_shared_grouped_tables(jnp.asarray(w), sj,
                                          jnp.float32(scale), 2,
                                          plan=jo.SegmentPlan(idx), fn=jfn)
    got = tp.build_shared_grouped_tables(torch.from_numpy(w), st,
                                         float(scale), 2,
                                         plan=to.SegmentPlan(idx), fn=tfn)
    assert got.group == want.group and got.pool.is_contiguous()
    np.testing.assert_array_equal(got.seg_idx.numpy(),
                                  np.asarray(want.seg_idx))  # the pool order
    tol = 0.0 if exact and fn == "mul" else 1e-6
    np.testing.assert_allclose(got.pool.numpy(), np.asarray(want.pool),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.materialize().numpy(),
                               np.asarray(want.materialize()), rtol=tol,
                               atol=tol)
    assert got.pool_bytes() == want.pool_bytes()
    assert got.dense_bytes() == want.dense_bytes()
    assert got.dedup_ratio == pytest.approx(want.dedup_ratio, rel=1e-12)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_scalar_tables_match(fn):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(9, 5)).astype(np.float32)
    sj, st = _specs(3)
    jfn, tfn = FNS[fn]
    want = np.asarray(jp.build_scalar_tables(jnp.asarray(w), sj,
                                             jnp.float32(0.3), fn=jfn))
    got = tp.build_scalar_tables(torch.from_numpy(w), st, 0.3, fn=tfn)
    assert got.shape == want.shape == (9, 8, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _low_cardinality(rng, shape, values=6):
    return rng.choice(rng.normal(size=values).astype(np.float32), size=shape)


@pytest.mark.parametrize("dedup", [False, True])
def test_shared_tables_match(dedup):
    rng = np.random.default_rng(10)
    w = _low_cardinality(rng, (12, 5))
    w[0, 0] = -0.0  # a signed zero among the values
    sj, st = _specs(2)
    want = jp.build_shared_tables(jnp.asarray(w), sj, jnp.float32(0.4),
                                  dedup_values=dedup)
    got = tp.build_shared_tables(torch.from_numpy(w), st, 0.4,
                                 dedup_values=dedup)
    assert got.actual_cardinality == want.actual_cardinality
    np.testing.assert_array_equal(got.w_idx.numpy(), np.asarray(want.w_idx))
    np.testing.assert_array_equal(got.unique_w.numpy(),
                                  np.asarray(want.unique_w))
    np.testing.assert_array_equal(got.pool.numpy(), np.asarray(want.pool))
    assert (got.value_pool is None) == (want.value_pool is None)
    if dedup:
        np.testing.assert_array_equal(got.value_pool.numpy(),
                                      np.asarray(want.value_pool))
    np.testing.assert_array_equal(got.materialize().numpy(),
                                  np.asarray(want.materialize()))
    gw, gg = want.as_grouped_pool(), got.as_grouped_pool()
    assert gg is got.as_grouped_pool()  # cached
    assert gg.group == 1
    np.testing.assert_array_equal(gg.seg_idx.numpy(), np.asarray(gw.seg_idx))
    np.testing.assert_array_equal(gg.pool.numpy(), np.asarray(gw.pool))
    codes = rng.integers(0, 4, size=(3, 12)).astype(np.int32)
    np.testing.assert_allclose(
        got.lookup(torch.from_numpy(codes)).numpy(),
        np.asarray(want.lookup(jnp.asarray(codes))), rtol=1e-6, atol=1e-6)


def test_shared_pool_bytes_matches():
    for args in [(5, 4, 2, 7, 4), (3, 2, 1, 9, 2, 10), (1, 8, 1, 3, 4, 6, 8)]:
        assert tp.shared_pool_bytes(*args) == jp.shared_pool_bytes(*args)


def test_shared_tables_cross_the_bridge():
    rng = np.random.default_rng(12)
    w = _low_cardinality(rng, (8, 3))
    for dedup in (False, True):
        st = jp.build_shared_tables(jnp.asarray(w), jq.QuantSpec(2), 0.5,
                                    dedup_values=dedup)
        got = tables_from_jax(st, "cpu")
        assert isinstance(got, tp.SharedTables)
        np.testing.assert_array_equal(got.materialize().numpy(),
                                      np.asarray(st.materialize()))


# ----------------------------------------------------------------------------
# the layer: pcilt_linear(plan=) on every path, SharedTables, refusals
# ----------------------------------------------------------------------------


def _plan_case(name, exact, bits=2):
    n, idx = PLANS[name]
    rng = np.random.default_rng(n * 7 + bits)
    w = _weights(rng, (n, 5), exact)
    scale = np.float32(0.5 if exact else 0.21)
    if exact:  # values on the code grid: every product and sum is exact
        x = (rng.integers(0, 1 << bits, size=(4, n)) * 0.5).astype(np.float32)
    else:
        x = rng.uniform(0.0, 0.8, size=(4, n)).astype(np.float32)
    sj, st = _specs(bits)
    jplan, tplan = jo.SegmentPlan(idx), to.SegmentPlan(idx)
    jt = jp.build_grouped_tables(jnp.asarray(w), sj, jnp.float32(scale),
                                 idx.shape[1], plan=jplan)
    return x, w, scale, sj, st, jplan, tplan, jt, to_torch(jt)


@pytest.mark.parametrize("path", ["gather", "onehot", "kernel", "fused"])
@pytest.mark.parametrize("name,exact", [("fig7", False), ("fig7", True),
                                        ("random", False), ("group3", True)])
def test_pcilt_linear_plan_matches_reference(name, exact, path):
    x, w, scale, sj, st, jplan, tplan, jt, tt = _plan_case(name, exact)
    group = jplan.group
    want = np.asarray(jl.pcilt_linear(jnp.asarray(x), jt, sj,
                                      jnp.float32(scale), group, plan=jplan,
                                      path=path))
    got = tl.pcilt_linear(torch.from_numpy(x), tt, st, float(scale), group,
                          plan=tplan, path=path).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the dense product on the quantized grid, through the plan
    codes = tq.quantize(torch.from_numpy(x), st, float(scale))
    xv = tq.dequantize(tplan.gather_codes(codes), st, float(scale))
    dense = torch.einsum("bgj,gjo->bo", xv,
                         tplan.gather_weights(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["gather", "fused"])
def test_pcilt_linear_plan_return_stats(path):
    x, _, scale, sj, st, jplan, tplan, jt, tt = _plan_case("random", False)
    x = x * 3.0  # some activations saturate
    wo, wc, wr = jl.pcilt_linear(jnp.asarray(x), jt, sj, jnp.float32(scale),
                                 2, plan=jplan, path=path, return_stats=True)
    go, gc, gr = tl.pcilt_linear(torch.from_numpy(x), tt, st, float(scale), 2,
                                 plan=tplan, path=path, return_stats=True)
    assert int(gc) == int(wc) > 0 and float(gr) == float(wr)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-5,
                               atol=1e-5)


FUSED_PLAN = [  # plan name, bits, symmetric, O, table dtype, exact grid
    ("fig7", 2, False, 5, "float32", False),
    ("random", 4, True, 130, "float32", False),   # ragged O, odd G, n != G*g
    ("random", 4, True, 130, "float32", True),
    ("group3", 2, True, 24, "bfloat16", False),
]


@pytest.mark.parametrize("name,bits,sym,O,dtype,exact", FUSED_PLAN)
def test_fused_plan_plain_matches_pallas(name, bits, sym, O, dtype, exact):
    """The port's plain version of kernel 11 against the Pallas kernel
    (interpret mode): bit-equal on the exact grid, float32 within 1e-6,
    bfloat16 within 1e-2 (one rounding of the float32 sum)."""
    n, idx = PLANS[name]
    group = idx.shape[1]
    rng = np.random.default_rng(O + bits)
    w = _weights(rng, (n, O), exact)
    scale = np.float32(0.5 if exact else 0.19)
    sj, st = _specs(bits, sym)
    jplan = jo.SegmentPlan(idx)
    tabs = jp.build_grouped_tables(jnp.asarray(w), sj, scale, group,
                                   plan=jplan).astype(jnp.dtype(dtype))
    x = (2.0 * rng.normal(size=(3, n))).astype(np.float32)
    want = _f32(jops.pcilt_fused_gemv_plan(jnp.asarray(x), tabs,
                                           jnp.asarray(idx), sj, scale,
                                           group))
    got = tops.pcilt_fused_gemv_plan(torch.from_numpy(x), to_torch(tabs),
                                     torch.from_numpy(idx), st, float(scale),
                                     group)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-2 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_unused_slot_offsets():
    """A -1 slot: the fused kernel (and its plain version) quantize x = 0.0,
    giving the zero point's code; ``plan.pack`` gives code 0.  Tables with
    non-zero rows there tell the two apart, and each side equals the
    reference's."""
    sj, st = _specs(2, True)  # zero point 2
    rng = np.random.default_rng(14)
    tabs = rng.normal(size=(3, 16, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, size=(2, 8)).astype(np.float32)
    scale = 0.4
    codes = tq.quantize(torch.from_numpy(x), st, scale)
    off = to.SegmentPlan(FIG7).pack(codes, 2)
    np.testing.assert_array_equal(
        off.numpy(), np.asarray(jo.SegmentPlan(FIG7).pack(
            jnp.asarray(codes.numpy()), 2)))
    assert (off[:, 2] & 3).eq(0).all()  # slot 0 of segment 2: code 0
    fused_off = off.clone()
    fused_off[:, 2] |= st.zero_point  # the kernel's code for x = 0.0
    got = tops.pcilt_fused_gemv_plan(torch.from_numpy(x),
                                     torch.from_numpy(tabs),
                                     torch.from_numpy(FIG7), st, scale, 2)
    want_fused = np.asarray(jops.pcilt_fused_gemv_plan(
        jnp.asarray(x), jnp.asarray(tabs), jnp.asarray(FIG7), sj,
        np.float32(scale), 2))
    np.testing.assert_allclose(got.numpy(), want_fused, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), tl.lut_lookup(torch.from_numpy(tabs), fused_off).numpy(),
        rtol=1e-6, atol=1e-6)
    assert not np.allclose(got.numpy(), tl.lut_lookup(
        torch.from_numpy(tabs), off).numpy())


def test_fused_plan_wrapper_refuses_bad_operands():
    spec = tq.QuantSpec(2)
    x, tabs = torch.zeros(2, 8), torch.zeros(3, 16, 4)
    with pytest.raises(ValueError, match="plan_idx shape"):
        tops.pcilt_fused_gemv_plan(x, tabs, torch.zeros(2, 2, dtype=torch.int32),
                                   spec, 1.0, 2)
    with pytest.raises(TypeError):
        tops.pcilt_fused_gemv_plan(x, tabs, torch.from_numpy(FIG7).long(),
                                   spec, 1.0, 2)
    with pytest.raises(ValueError, match="position 7"):
        tops.pcilt_fused_gemv_plan(torch.zeros(2, 7), tabs,
                                   torch.from_numpy(FIG7), spec, 1.0, 2)


def _refusals(pc, lin, plan_cls, x, w, spec, scale):
    """Each call the reference refuses with a ValueError, built by one
    package's ``pcilt`` module ``pc`` and run by its ``pcilt_linear``."""
    plan = plan_cls(FIG7)
    T = pc.build_grouped_tables(w, spec, scale, 2, plan=plan)
    st = pc.build_shared_grouped_tables(w, spec, scale, 2, plan=plan)
    stack = T[None]
    paired = pc.build_paired_tables(w, spec, scale, 2)
    scalar = pc.build_shared_tables(w, spec, scale)
    return {
        "paired+plan": (lambda: lin(x, paired, spec, scale, 2, plan=plan,
                                    path="fused", paired=True),
                        "SegmentPlan"),
        "stacked+plan": (lambda: lin(x, stack, spec, scale, 2, plan=plan,
                                     path="fused", stacked=0), "SegmentPlan"),
        "shared+plan": (lambda: lin(x, st, spec, scale, 2, plan=plan,
                                    path="shared"), "SegmentPlan"),
        "residual": (lambda: lin(x, T, spec, scale, 2, path="fused"),
                     "generalized SegmentPlan"),
        "residual names plan=": (lambda: lin(x, T, spec, scale, 2,
                                             path="fused"), "plan="),
        "plan grid": (lambda: lin(x, T, spec, scale, 1, plan=plan,
                                  path="fused"), "plan grid"),
        "scalar shared+paired": (lambda: lin(x, scalar, spec, scale, 2,
                                             path="gather", paired=True),
                                 "SharedTables"),
    }


def test_plan_refusals_match_the_reference():
    rng = np.random.default_rng(15)
    x = rng.uniform(0, 1, size=(2, 8)).astype(np.float32)
    w = rng.normal(size=(8, 3)).astype(np.float32)
    want = _refusals(jp, jl.pcilt_linear, jo.SegmentPlan, jnp.asarray(x),
                     jnp.asarray(w), jq.QuantSpec(2), jnp.float32(0.3))
    got = _refusals(tp, tl.pcilt_linear, to.SegmentPlan, torch.from_numpy(x),
                    torch.from_numpy(w), tq.QuantSpec(2), 0.3)
    assert want.keys() == got.keys()
    for case in want:
        for fn, match in (want[case], got[case]):
            with pytest.raises(ValueError, match=match):
                fn()


@pytest.mark.parametrize("path", ["shared", "gather"])
@pytest.mark.parametrize("dedup", [False, True])
def test_scalar_shared_tables_through_pcilt_linear(path, dedup):
    """A scalar SharedTables runs as its 1-wide segment pool (``group``
    becomes 1) on "shared" (kernel 3's plain version) and "gather", equal to
    the reference and to the dense ``materialize()`` tables."""
    rng = np.random.default_rng(16)
    w = _low_cardinality(rng, (10, 6), values=4)
    x = rng.uniform(0, 2, size=(3, 10)).astype(np.float32)
    sj, st = _specs(2)
    scale = 0.6
    jst = jp.build_shared_tables(jnp.asarray(w), sj, jnp.float32(scale),
                                 dedup_values=dedup)
    tst = tp.build_shared_tables(torch.from_numpy(w), st, scale,
                                 dedup_values=dedup)
    want = np.asarray(jl.pcilt_linear(jnp.asarray(x), jst, sj,
                                      jnp.float32(scale), 2, path=path))
    got = tl.pcilt_linear(torch.from_numpy(x), tst, st, scale, 2,
                          path=path).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dense = tl.pcilt_linear(torch.from_numpy(x), tst.materialize(), st, scale,
                            1, path="gather").numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


def test_core_exports_the_reference_names():
    mesh_only = {"ShardedSharedPool", "shard_shared_grouped_tables",
                 "mesh_shard_count"}
    ref = {k for k in vars(jcore) if not k.startswith("_")
           and not getattr(vars(jcore)[k], "__name__", "").startswith(
               "repro.core.")}
    missing = sorted(ref - mesh_only - set(vars(tcore)))
    assert not missing, missing
    assert not mesh_only & set(vars(tcore))
