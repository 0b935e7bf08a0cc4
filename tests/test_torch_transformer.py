"""Port parity of the dense transformer family at the qwen3 smoke config
(2 layers, d 64, 4 heads over 2 KV heads, head_dim 32, qk-norm, tied
embeddings), and of ``MambaLM.prefill``.

The JAX package's parameters cross the numpy bridge, so both packages
compute on identical weights.  Tolerances:

* float32 compute (``dataclasses.replace(cfg, dtype=float32)``): outputs
  to 1e-5 relative (``|d| <= 1e-5 * |want| + 1e-5 * max|want|``: float32
  sums in another order), and to 1e-4 where a step attends to the
  bfloat16 KV cache (a decode step): a cached value that rounds to the
  neighbouring bfloat16 value in one framework moves that step's logits
  by up to ~3e-5 of the largest;
* bfloat16 compute (the config's own): logits within 2e-2 of the largest
  logit, argmax equal (XLA and torch round some bfloat16 element-wise
  steps differently: XLA's CPU logistic rounds each of its ops);
* the KV cache is bfloat16 in both: bit-equal where a step carries it
  over unchanged (the slots a decode step does not write), else within
  one bfloat16 step in float32 compute (projections that agree to ~1e-7
  round to neighbouring bfloat16 values where they straddle a rounding
  boundary; how often depends on each framework's summation order, which
  can change with its thread count) and within 2e-2 of the largest value
  in bfloat16 compute.

Attention is checked function by function against the JAX functions (rope,
the interleaved GQA repeat, the float32 dense path, the chunked path at S
= 1536 in three query blocks, the dispatch at S*S = 2048**2, the decode
write before and past the cache's end), then whole models: prefill plus six
decode steps, a decode replay into an engine-sized cache past its end, the
sliding window with QKV bias, and the Mamba prefill whose cache the port
then decodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.launch.steps import make_decode_step as j_decode_step
from repro.models import build_model as j_build
from repro.nn import attention as ja
from repro.nn import layers as jl
from repro.nn.layers import Ctx
from repro.nn.module import ParamSpec as JSpec
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_numpy, to_torch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import MambaLM, TransformerLM, build_model
from repro_torch.nn import attention as ta
from repro_torch.nn import layers as tl
from repro_torch.nn.module import ParamSpec as TSpec
from repro_torch.nn.module import materialize
from test_torch_donor import jax_donor

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CTX = Ctx()
STEPS = 6


def _cfgs(dt, **kw):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(j_smoke("qwen3-0.6b"), dtype=jd, **kw),
            dataclasses.replace(t_smoke("qwen3-0.6b"), dtype=td, **kw))


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy."""
    if torch.is_tensor(a):
        a = to_numpy(a)
    return np.asarray(np.asarray(a).astype(np.float32))


def _close_f32(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _close_bf16_logits(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _close_cached(got, want):
    """A float32 output computed from the bfloat16 KV cache."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _close(dt, got, want, cached=False):
    if dt == "bf16":
        _close_bf16_logits(got, want)
    else:
        (_close_cached if cached else _close_f32)(got, want)


def _bit_equal(got, want):
    np.testing.assert_array_equal(to_numpy(got).view(np.uint16),
                                  np.asarray(want).view(np.uint16))


def _one_bf16_step(got, want):
    """Within one bfloat16 step of each other (2**-7 relative)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def donor():
    """The JAX smoke model's parameters (float32), as numpy."""
    jcfg, _ = _cfgs("f32")
    jp = jax_donor(j_build(jcfg).param_specs(), 0)
    return jax.tree.map(np.asarray, jp)


# -- the spec trees --------------------------------------------------------


def _spec_leaves(tree, spec_type, prefix=""):
    if isinstance(tree, spec_type):
        return {prefix: (tuple(tree.shape), np.dtype(tree.dtype).name
                         if not isinstance(tree.dtype, torch.dtype)
                         else str(tree.dtype).removeprefix("torch."))}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, spec_type, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_spec_trees_match_reference(size):
    """Parameter and cache specs: the reference's key paths, shapes and
    dtypes (the full config by shape only, nothing materialized)."""
    get_j, get_t = (j_smoke, t_smoke) if size == "smoke" else (j_full, t_full)
    jm, tm = j_build(get_j("qwen3-0.6b")), build_model(get_t("qwen3-0.6b"))
    assert isinstance(tm, TransformerLM)
    assert _spec_leaves(tm.param_specs(), TSpec) == \
        _spec_leaves(jm.param_specs(), JSpec)
    assert _spec_leaves(tm.cache_specs(4, 256), TSpec) == \
        _spec_leaves(jm.cache_specs(4, 256), JSpec)


def test_config_matches_reference():
    for get_j, get_t in ((j_smoke, t_smoke), (j_full, t_full)):
        j, t = get_j("qwen3-0.6b"), get_t("qwen3-0.6b")
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias",
                  "qk_norm", "window", "rope_theta", "pos_embed",
                  "pad_heads_to", "pad_kv_heads_to", "tie_embeddings",
                  "norm_eps", "remat_policy", "loss_chunk", "padded_vocab",
                  "resolved_head_dim", "padded_heads", "padded_kv_heads",
                  "attention_free"):
            assert getattr(t, f) == getattr(j, f), f


def test_build_model_dispatch():
    from repro_torch.models import HybridLM

    assert isinstance(build_model(t_smoke("mamba2-130m")), MambaLM)
    assert isinstance(build_model(t_smoke("qwen3-0.6b")), TransformerLM)
    assert isinstance(build_model(t_smoke("granite-moe-3b-a800m")),
                      TransformerLM)
    assert isinstance(build_model(t_smoke("zamba2-7b")), HybridLM)
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        model = build_model(t_smoke(arch))
        assert isinstance(model, TransformerLM)
        assert model.cfg.family in ("audio", "vlm")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(t_smoke("qwen3-0.6b"),
                                        family="other"))


# -- attention, function by function ---------------------------------------


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_matches_reference(theta, dt):
    """Split halves, float32 angles; equal to the reference's to one
    float32 rounding of the rotation (exact frequencies)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 37))
    xj = jnp.asarray(x).astype(DTYPES[dt][0])
    want = jl.rope(xj, jnp.asarray(pos), theta)
    got = tl.rope(to_torch(np.asarray(xj)), torch.from_numpy(pos), theta)
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=4e-6 if dt == "f32" else 2 ** -7)


def test_repeat_kv_is_interleaved():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 8, 4)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    jk, jv = ja._repeat_kv(CTX, *map(jnp.asarray, (q, k, v)))
    tk, tv = ta._repeat_kv(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[:, :, 5], k[:, :, 1])


def _qkv(S, T, dt, seed=2, H=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, n, H, 32)).astype(np.float32)
               for n in (S, T, T))
    jd = DTYPES[dt][0]
    js_ = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    return js_, [to_torch(np.asarray(a)) for a in js_]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sdpa_dense_matches_reference(dt):
    jcfg, tcfg = _cfgs(dt)
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 7, dt)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    jm = ja._causal_mask(jnp.asarray(pos), jnp.asarray(pos), 0)
    tm = ta._causal_mask(torch.from_numpy(pos.copy()),
                         torch.from_numpy(pos.copy()), 0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = ja._sdpa_dense(jcfg, CTX, jq, jk, jv, jm)
    got = ta._sdpa_dense(tcfg, tq, tk, tv, tm)
    assert got.dtype == DTYPES[dt][1]
    if dt == "f32":
        _close_f32(got, want)
    else:  # one rounding of the float32 result to bfloat16
        _one_bf16_step(got, want)


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sdpa_chunked_matches_reference(dt, window):
    """S = 1536: three query blocks of 512 (1024 halved until it divides
    S); with a window, the window's mask in every block."""
    S = 1536
    jcfg, tcfg = _cfgs(dt, window=window)
    (jq, jk, jv), (tq, tk, tv) = _qkv(S, S, dt, seed=3)
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).copy()
    want = ja._sdpa_chunked(jcfg, CTX, jq, jk, jv, jnp.asarray(pos),
                            jnp.asarray(pos), causal=True)
    got = ta._sdpa_chunked(tcfg, tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(pos), causal=True)
    if dt == "f32":
        _close_f32(got, want)
    else:  # the bf16 probabilities and outputs round once each
        _one_bf16_step(got, want)


@pytest.mark.parametrize("S,path", [(2047, "_sdpa_dense"),
                                    (2048, "_sdpa_chunked")])
def test_full_sequence_dispatch(S, path, donor, monkeypatch):
    """A full-sequence pass takes the chunked path from S*S >= 2048**2,
    as the reference's, and agrees with it; the cache holds the pass's K/V
    in bfloat16 (rounded from float32 projections that agree to ~1e-7, so
    within one bfloat16 step: a few of the 131k values sit at a rounding
    boundary)."""
    jcfg, tcfg = _cfgs("f32")
    jp = jax.tree.map(lambda a: a[0], donor["blocks"])["sub0"]["attn"]
    tp = params_from_jax(jp, "cpu")
    x = np.random.default_rng(4).standard_normal((1, S, 64)) \
        .astype(np.float32)
    pos = np.arange(S)[None]
    calls = []
    for name in ("_sdpa_dense", "_sdpa_chunked"):
        fn = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    with torch.no_grad():
        got, tc = ta.attention(tp, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    assert calls == [path]
    want, jc = ja.attention(jax.tree.map(jnp.asarray, jp), jcfg, CTX,
                            jnp.asarray(x), jnp.asarray(pos))
    _close_f32(got, want)
    for n in ("k", "v"):
        assert tc[n].dtype == torch.bfloat16
        _one_bf16_step(tc[n], jc[n])


@pytest.mark.parametrize("pos", [3, 7, 8, 13])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_write(pos, window, donor):
    """One decode step into a T = 8 cache: the write lands at ``pos``,
    clamped to the last slot past the end (the reference's
    ``dynamic_update_slice``), or at ``pos mod T`` in the rolling window;
    the mask admits the slots written so far.  The slots not written are
    carried over bit-equal, the written one within one bfloat16 step;
    outputs to 1e-4 (they read the written slot)."""
    jcfg, tcfg = _cfgs("f32", window=window)
    jp = jax.tree.map(lambda a: a[1], donor["blocks"])["sub0"]["attn"]
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(5 + pos)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    k0, v0 = (jnp.asarray(rng.standard_normal((3, 8, 2, 32)))
              .astype(jnp.bfloat16) for _ in range(2))
    positions = np.full((3, 1), pos)
    want, jc = ja.attention(jax.tree.map(jnp.asarray, jp), jcfg, CTX,
                            jnp.asarray(x), jnp.asarray(positions),
                            cache={"k": k0, "v": v0,
                                   "pos": jnp.asarray(pos, jnp.int32)})
    tk0, tv0 = to_torch(np.asarray(k0)), to_torch(np.asarray(v0))
    with torch.no_grad():
        got, tc = ta.attention(tp, tcfg, torch.from_numpy(x),
                               torch.from_numpy(positions),
                               cache={"k": tk0, "v": tv0, "pos": pos})
    _close_cached(got, want)
    slot = pos % 8 if window else min(pos, 7)
    kept = [t for t in range(8) if t != slot]
    for n in ("k", "v"):
        _bit_equal(tc[n][:, kept], np.asarray(jc[n])[:, kept])
        _one_bf16_step(tc[n][:, slot], np.asarray(jc[n])[:, slot])
    changed = (to_numpy(tc["k"]) != np.asarray(k0)).any(axis=(0, 2, 3))
    assert list(np.nonzero(changed)[0]) == [slot]
    # the given cache is not changed
    _bit_equal(tk0, k0)


# -- whole models ----------------------------------------------------------


def _port_cache(jc):
    """The reference's decode cache as the port's (``pos`` a host int)."""
    return {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                   jc["layers"]), "pos": int(jc["pos"])}


def _prefill_decode(jcfg, tcfg, params, tokens, steps=STEPS):
    """Both models' prefill then ``steps`` greedy decode steps, the
    reference's tokens fed to both.  Each port step starts from the
    reference's cache: a float32 ulp between the packages can round a
    bfloat16 cache entry the other way at a tie (one bfloat16 step, which
    the cache checks allow), and a chained comparison would carry that
    step into every later logit.  Returns the logits and caches of every
    stage."""
    jm, tm = j_build(jcfg), build_model(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    out = []
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, {"tokens":
                                               torch.from_numpy(tokens)})
    out.append((jl_, tl_, jc, tc))
    step = make_decode_step(tcfg)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
        jc_in = jc
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, _port_cache(jc_in), torch.from_numpy(tok))
        out.append((jl_, tl_, jc, tc))
    return out


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dt, donor):
    """A 12-token prompt at B = 3, then six decode steps: the prefill cache
    is the prompt's length, so every step writes the clamped last slot, as
    the reference's does."""
    jcfg, tcfg = _cfgs(dt)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (3, 12))
    stages = _prefill_decode(jcfg, tcfg, donor, tokens)
    for i, (jl_, tl_, jc, tc) in enumerate(stages):
        assert tl_.dtype == DTYPES[dt][1] and tl_.shape == jl_.shape
        _close(dt, tl_, jl_, cached=i > 0)
        assert tc["pos"] == int(jc["pos"]) == 12 + i
        for n in ("k", "v"):
            got, want = tc["layers"]["sub0"][n], jc["layers"]["sub0"][n]
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            if dt == "f32":
                _one_bf16_step(got, want)
            else:
                g, w = _np(got), _np(want)
                assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_decode_replay_past_the_cache_end(donor):
    """An engine-sized cache (T = 8, zeros, ``pos`` 0) fed 12 tokens: steps
    past T write the clamped last slot, as the reference's; logits and
    caches agree at every step."""
    jcfg, tcfg = _cfgs("f32")
    jm, tm = j_build(jcfg), build_model(tcfg)
    jp = jax.tree.map(jnp.asarray, donor)
    tp = params_from_jax(donor, "cpu")
    jc = jax_donor(jm.cache_specs(2, 8), 1)
    jc = dict(jc, pos=jnp.asarray(0, jnp.int32))
    tc = {"layers": params_from_jax(jax.tree.map(np.asarray, jc["layers"]),
                                    "cpu"), "pos": 0}
    jstep = j_decode_step(jcfg, None)
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 12))
    for t in range(12):
        tok = tokens[:, t:t + 1]
        jl_, jc = jstep(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl_, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_cached(tl_, jl_)
        for n in ("k", "v"):
            _one_bf16_step(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n])
    assert tc["pos"] == 12


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_matches_a_decode_replay(dt, donor):
    """The port against itself: ``make_prefill_step`` on a 20-token prompt
    and a replay of the prompt through ``make_decode_step`` into a 32-slot
    cache.  The replay attends to the bfloat16 cache where the prefill
    attends to its float32 (or bfloat16) K/V, so in either compute dtype
    the last logits agree within 2e-2 of the largest with the argmax equal,
    and the prompt's K/V within 2e-2 of the largest value."""
    _, tcfg = _cfgs(dt)
    model = build_model(tcfg)
    tp = params_from_jax(donor, "cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(11).integers(0, tcfg.vocab, (2, 20)))
    with torch.no_grad():
        want, pcache = make_prefill_step(tcfg)(tp, {"tokens": prompt})
        cache = dict(materialize(model.cache_specs(2, 32), 0, device="cpu"), pos=0)
        step = make_decode_step(tcfg)
        for t in range(20):
            got, cache = step(tp, cache, prompt[:, t:t + 1])
    assert cache["pos"] == pcache["pos"] == 20
    _close_bf16_logits(got, want)
    for n in ("k", "v"):
        g = _np(cache["layers"]["sub0"][n][:, :, :20])
        w = _np(pcache["layers"]["sub0"][n])
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_window_and_qkv_bias(donor):
    """``window=4`` and ``qkv_bias=True`` (seeded nonzero biases): prefill
    with the window's mask, then decode steps through the rolling buffer
    (T = 4 once ``init_cache_specs`` sizes it; here the prefill cache of
    the prompt's length, which the window's modulo addresses)."""
    jcfg, tcfg = _cfgs("f32", window=4, qkv_bias=True)
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda a: a, donor)
    attn = params["blocks"]["sub0"]["attn"]
    for n in ("wq", "wk", "wv"):
        attn[n] = dict(attn[n], bias=(0.1 * rng.standard_normal(
            attn[n]["kernel"].shape[:1] + attn[n]["kernel"].shape[2:]))
            .astype(np.float32))
    tm = build_model(tcfg)
    assert _spec_leaves(tm.param_specs(), TSpec) == \
        _spec_leaves(j_build(jcfg).param_specs(), JSpec)
    assert tm.cache_specs(2, 256)["layers"]["sub0"]["k"].shape[2] == 4
    tokens = rng.integers(0, jcfg.vocab, (2, 9))
    for i, (jl_, tl_, jc, tc) in enumerate(
            _prefill_decode(jcfg, tcfg, params, tokens)):
        _close("f32", tl_, jl_, cached=i > 0)
        for n in ("k", "v"):
            _one_bf16_step(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n])


def test_padded_vocab_is_never_sampled(donor):
    """``make_decode_step`` sets the padded ids' logits to -1e30, as the
    reference's."""
    jcfg, tcfg = _cfgs("f32", vocab=250)
    assert tcfg.padded_vocab == 256
    jm, tm = j_build(jcfg), build_model(tcfg)
    tokens = np.random.default_rng(9).integers(0, 250, (2, 5))
    _, jc = jm.prefill(jax.tree.map(jnp.asarray, donor),
                       {"tokens": jnp.asarray(tokens)}, CTX)
    tp = params_from_jax(donor, "cpu")
    with torch.no_grad():
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
        got, _ = make_decode_step(tcfg)(tp, tc, torch.full((2, 1), 3))
    want, _ = j_decode_step(jcfg, None)(jax.tree.map(jnp.asarray, donor),
                                        jc, jnp.full((2, 1), 3, jnp.int32))
    assert (got[:, 250:] == -1e30).all()
    np.testing.assert_array_equal(np.asarray(want)[:, 250:], np.float32(-1e30))
    _close_cached(got[:, :250], np.asarray(want)[:, :250])


# -- the Mamba prefill -----------------------------------------------------


def test_mamba_prefill_matches_reference():
    """``MambaLM.prefill`` on a 16-token prompt against the reference's
    (logits and the final conv/ssd states to 2e-2: the SSD keeps its O(T)
    operands in bfloat16 in both packages, summed in other orders), then the
    reference's cache decoded four steps by the port against the
    reference's own decode (1e-4)."""
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"), dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"), dtype=torch.float32)
    jm, tm = j_build(jcfg), build_model(tcfg)
    jp = jax_donor(jm.param_specs(), 0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(10).integers(0, jcfg.vocab, (2, 16))
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, {"tokens":
                                               torch.from_numpy(tokens)})
    assert set(tc) == {"layers"} and int(jc["pos"]) == 16
    got, want = _np(tl_), _np(jl_)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    for n in ("conv", "ssd"):
        assert tc["layers"][n].shape == jc["layers"][n].shape
        g, w = _np(tc["layers"][n]), _np(jc["layers"][n])
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
    # the reference's cache through the port's decode
    tc = {"layers": params_from_jax(jax.tree.map(np.asarray, jc["layers"]),
                                    "cpu")}
    tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
    for _ in range(4):
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(tl_), _np(jl_), rtol=1e-4, atol=1e-4)
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
