"""Port parity of the three other dense configs: qwen1.5-4b (QKV bias, an
untied head, 20 heads padded to 32 over as many KV heads), qwen2.5-3b
(QKV bias, GQA 16 over 2, tied) and deepseek-coder-33b (an untied head,
56 query heads padded to 64 over 8 KV heads, rope theta 1e5).

Each full ``config()`` equals the reference's field by field and builds
the same parameter and cache specs.  At each smoke config (and at padded
head counts, which the smoke configs do not have: head ``h`` reads KV head
``h // rep`` over the padded counts, as the reference repeats them) the
JAX package's parameters cross the numpy bridge and, in float32 compute,
the prefill logits agree to 1e-5 and each decode step's to 1e-4 (it
attends to the bfloat16 KV cache), and the port's ``Engine`` serves the
JAX ``Engine``'s request stream with the same tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as js
from repro.models import build_model as j_build
from repro.nn.layers import Ctx
from repro.nn.module import ParamSpec as JSpec
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_numpy, to_torch
from repro_torch.launch import serve as ts
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import TransformerLM, build_model
from repro_torch.nn.module import ParamSpec as TSpec
from test_torch_donor import hash_free_engines, jax_donor

CONFIGS = ["qwen1.5-4b", "qwen2.5-3b", "deepseek-coder-33b"]
#: smoke configs at padded head counts (query heads, KV heads)
PADDED = {"qwen1.5-4b": dict(pad_heads_to=8, pad_kv_heads_to=8),
          "deepseek-coder-33b": dict(pad_heads_to=12)}
CTX = Ctx()


def _np(a):
    if torch.is_tensor(a):
        return to_numpy(a).astype(np.float32)
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _spec_leaves(tree, spec_type, prefix=""):
    if isinstance(tree, spec_type):
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, spec_type, f"{prefix}/{k}"))
    return out


def test_registry_has_the_dense_family():
    # the other ported families' configs beside the dense ones
    assert set(CONFIGS) | {"qwen3-0.6b", "mamba2-130m", "granite-moe-3b-a800m",
                           "llama4-maverick-400b-a17b", "zamba2-7b",
                           "whisper-medium", "llava-next-mistral-7b"} \
        == set(ARCHS)


@pytest.mark.parametrize("arch", CONFIGS)
def test_full_config_matches_reference(arch):
    for get_j, get_t in ((j_full, t_full), (j_smoke, t_smoke)):
        j, t = get_j(arch), get_t(arch)
        for f in dataclasses.fields(t):
            if f.name in ("dtype", "param_dtype"):
                assert str(getattr(t, f.name)).removeprefix("torch.") == \
                    jnp.dtype(getattr(j, f.name)).name, f.name
            else:
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        for p in ("padded_vocab", "resolved_head_dim", "padded_heads",
                  "padded_kv_heads", "attention_free"):
            assert getattr(t, p) == getattr(j, p), p


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_spec_trees_match_reference(arch, size):
    get_j, get_t = (j_smoke, t_smoke) if size == "smoke" else (j_full, t_full)
    jm, tm = j_build(get_j(arch)), build_model(get_t(arch))
    assert isinstance(tm, TransformerLM)
    assert _spec_leaves(tm.param_specs(), TSpec) == \
        _spec_leaves(jm.param_specs(), JSpec)
    assert _spec_leaves(tm.cache_specs(2, 64), TSpec) == \
        _spec_leaves(jm.cache_specs(2, 64), JSpec)


def _cases():
    out = [(a, "smoke") for a in CONFIGS]
    return out + [(a, "padded") for a in PADDED]


def _one_bf16_step(got, want):
    """Within one bfloat16 step of each other (2**-7 relative)."""
    got, want = to_numpy(got).astype(np.float32), \
        np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


def _cfgs(arch, variant):
    kw = PADDED[arch] if variant == "padded" else {}
    return (dataclasses.replace(j_smoke(arch), dtype=jnp.float32, **kw),
            dataclasses.replace(t_smoke(arch), dtype=torch.float32, **kw))


def _donor(jcfg, seed=0):
    """The JAX parameters, with seeded nonzero QKV biases where the config
    has them (the reference draws them zero)."""
    jp = jax_donor(j_build(jcfg).param_specs(), seed)
    params = jax.tree.map(np.asarray, jp)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = params["blocks"]["sub0"]["attn"]
        for n in ("wq", "wk", "wv"):
            attn[n] = dict(attn[n], bias=(0.1 * rng.standard_normal(
                attn[n]["bias"].shape)).astype(np.float32))
    return params


@pytest.mark.parametrize("arch,variant", _cases())
def test_prefill_and_decode_match_reference(arch, variant):
    jcfg, tcfg = _cfgs(arch, variant)
    params = _donor(jcfg)
    jm = j_build(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 10))
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, {"tokens":
                                               torch.from_numpy(tokens)})
    want = _np(jl_)
    np.testing.assert_allclose(_np(tl_), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    step = make_decode_step(tcfg)
    for _ in range(4):
        # each step from the reference's cache: a float32 ulp can round a
        # bfloat16 entry the other way at a tie (one bfloat16 step, checked
        # below), which a chained comparison would carry forward
        for n in ("k", "v"):
            _one_bf16_step(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n])
        tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                     jc["layers"]), "pos": int(jc["pos"])}
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None]
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, tc, torch.from_numpy(tok))
        want = _np(jl_)
        np.testing.assert_allclose(_np(tl_), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(_np(tl_).argmax(-1), want.argmax(-1))
    assert tc["pos"] == int(jc["pos"]) == 14


@pytest.mark.parametrize("arch", CONFIGS)
def test_engine_serves_the_reference_tokens(arch):
    """Three requests of 8 new tokens over 2 slots (prompts replayed into
    the cache, a slot recycled): the same tokens and outcomes as the JAX
    engine on the same parameters."""
    jcfg, tcfg = _cfgs(arch, "smoke")
    with hash_free_engines():
        jeng = js.Engine(jcfg, max_len=64, slots=2)
    jreqs = js._make_requests(jcfg, 3, 8, None, 0)
    jstats = jeng.run(jreqs)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    teng = ts.Engine(tcfg, 64, 2, device="cpu", params=params)
    treqs = ts.make_requests(tcfg, 3, 8, 0)
    tstats = teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.outcome for r in treqs] == ["served"] * 3
    assert tstats["served"] == jstats["served"] == 3
