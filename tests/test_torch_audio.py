"""Port parity of the audio family (whisper) at its smoke config (2 encoder
and 2 decoder layers, d 64, 4 heads, d_ff 128, 16 stub frames), against
``repro.nn.layers``, ``repro.nn.attention`` and
``repro.models.transformer``.

Both packages compute on the same donor weights (``jax_donor``).
Tolerances:

* ``layernorm`` and ``sinusoidal_positions`` in float32: within 4 float32
  ulps of the largest magnitude (another summation order in the mean;
  ``sin`` and ``cos`` of angles up to 4200 from two libraries);
* the GELU MLP: float32 1e-6 of the largest output; bfloat16 one
  bfloat16 rounding (2**-7 of the largest output: both round each step of
  the tanh form, a product straddling a rounding boundary can go either
  way);
* whole models in float32 compute (``dataclasses.replace(cfg,
  dtype=float32)``): 1e-5 of the largest value for the loss, the prefill
  logits, the encoder and cross-attention outputs; 1e-4 for the gradients'
  entries and for logits computed from the bfloat16 cross or KV cache (a
  value rounding to the neighbouring bfloat16 moves them by ~3e-5); the
  bfloat16 caches within one bfloat16 step (2**-7 of the largest); the
  port's decode replay of a prefill within 2e-2 (it attends to the
  bfloat16 cache where the prefill attends to float32 K/V);
* bfloat16 compute (the config's own): within 2e-2 of the largest value.

The chunked cross-attention runs with ``_CHUNK_THRESHOLD`` lowered in
both packages, so that a 12 x 16 cross-attention takes it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as js
from repro.models import build_model as j_build
from repro.models import transformer as jt
from repro.nn import attention as ja
from repro.nn import layers as jl
from repro.nn.layers import Ctx
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.checkpoint import restore, save
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import (params_from_jax, to_torch, tree_leaves,
                                 tree_map)
from repro_torch.launch import serve as ts
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import TransformerLM
from repro_torch.models import build_model as t_build
from repro_torch.models import transformer as tt
from repro_torch.nn import attention as ta
from repro_torch.nn import layers as tl
from repro_torch.nn.module import materialize
from test_torch_donor import hash_free_engines, jax_donor

ARCH = "whisper-medium"
CTX = Ctx()
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 12


def _cfgs(dt="f32"):
    jd, td = DTYPES[dt]
    return (dataclasses.replace(j_smoke(ARCH), dtype=jd),
            dataclasses.replace(t_smoke(ARCH), dtype=td))


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    """``|got - want| <= tol * max|want|``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def donor():
    return jax.tree.map(np.asarray, jax_donor(
        j_build(_cfgs()[0]).param_specs(), 0))


def _batch(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
            "loss_mask": (rng.uniform(size=(B, s)) > 0.2).astype(np.float32),
            "memory": rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- configs ---------------------------------------------------------------


def test_configs_and_registry_match_reference():
    assert T_ARCHS == J_ARCHS
    for get_j, get_t in ((j_full, t_full), (j_smoke, t_smoke)):
        for arch in ("whisper-medium", "llava-next-mistral-7b"):
            j, t = get_j(arch), get_t(arch)
            for f in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "head_dim", "window",
                      "rope_theta", "pos_embed", "encoder_layers",
                      "encoder_len", "n_img_tokens", "remat_policy",
                      "loss_chunk", "tie_embeddings", "qkv_bias", "qk_norm",
                      "padded_vocab", "resolved_head_dim", "padded_heads",
                      "padded_kv_heads", "attention_free", "sub_quadratic"):
                assert getattr(t, f) == getattr(j, f), (arch, f)
    for arch in T_ARCHS:
        assert t_full(arch).sub_quadratic == j_full(arch).sub_quadratic


def test_param_and_cache_specs_match_reference():
    def shapes(tree):
        return {k: tuple(v.shape) for k, v in _flat(tree).items()}

    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    assert isinstance(tm, TransformerLM)
    assert shapes(tm.param_specs()) == shapes(jm.param_specs())
    jc, tc = jm.cache_specs(3, 40), tm.cache_specs(3, 40)
    assert shapes(tc) == shapes(jc)
    assert tc["cross_kv"]["k"].dtype == torch.bfloat16
    assert tc["cross_kv"]["k"].shape == (2, 3, 16, 4, 16)


# -- layers ----------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layernorm_matches_reference(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jl.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x).astype(jd), 1e-5)
    got = tl.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(td), 1e-5)
    assert got.dtype == td
    if dt == "f32":
        _close(got, want, 4 * 2.0 ** -23)
    else:  # one bfloat16 rounding of float32 values that agree to ~1e-7
        _close(got, want, 2.0 ** -8)


@pytest.mark.parametrize("length,d,offset", [(16, 64, 0), (12, 64, 0),
                                             (1, 64, 7), (1, 1024, 4095),
                                             (8, 1024, 4096), (5, 2, 3),
                                             (100, 1024, 4000)])
def test_sinusoidal_positions_match_reference(length, d, offset):
    want = np.asarray(jl.sinusoidal_positions(length, d, offset))
    got = tl.sinusoidal_positions(length, d, offset).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (length, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -23)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gelu_mlp_matches_reference(dt, donor):
    jcfg, tcfg = _cfgs(dt)
    p = jax.tree.map(lambda a: a[0], donor["blocks"]["sub0"]["mlp"])
    assert sorted(p) == ["wi", "wo"] and "bias" in p["wi"]
    rng = np.random.default_rng(2)
    x = (2 * rng.standard_normal((B, 7, 64))).astype(np.float32)
    want = jt.mlp(jax.tree.map(jnp.asarray, p), jcfg, CTX,
                  jnp.asarray(x).astype(jcfg.dtype))
    got = tt.mlp(params_from_jax(p, "cpu"), tcfg,
                 torch.from_numpy(x).to(tcfg.dtype))
    assert got.dtype == tcfg.dtype
    _close(got, want, 1e-6 if dt == "f32" else 2.0 ** -7)
    # the activation alone, on a grid over [-4, 4]
    g = np.linspace(-4, 4, 4001).astype(np.float32)
    jd, td = DTYPES[dt]
    _close(tt._gelu(torch.from_numpy(g).to(td)),
           jax.nn.gelu(jnp.asarray(g).astype(jd)),
           1e-6 if dt == "f32" else 2.0 ** -7)


# -- cross-attention -------------------------------------------------------


def _cross_inputs(cfg, s, t, seed=3):
    rng = np.random.default_rng(seed)
    Hk, Dh = cfg.padded_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((B, t, Hk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, t, Hk, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (B, s)).astype(np.int32)
    return x, k, v, pos


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_cross_attention_matches_reference(path, dt, donor, monkeypatch):
    """The dense path at 12 x 16, and the chunked one with the threshold
    lowered in both packages (three query blocks of 4)."""
    jcfg, tcfg = _cfgs(dt)
    if path == "chunked":
        monkeypatch.setattr(ja, "_CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(ta, "_CHUNK_THRESHOLD", 8)
    seen = []
    for mod in (ja, ta):
        for fn in ("_sdpa_dense", "_sdpa_chunked"):
            orig = getattr(mod, fn)
            monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k:
                                seen.append(_n) or _o(*a, **k))
    p = jax.tree.map(lambda a: a[0], donor["blocks"]["sub0"]["cross"])
    x, k, v, pos = _cross_inputs(jcfg, S, 16)
    kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    want, _ = ja.attention(jax.tree.map(jnp.asarray, p), jcfg, CTX,
                           jnp.asarray(x).astype(jcfg.dtype),
                           jnp.asarray(pos), causal=False, cross_kv=(kb, vb))
    got, cache = ta.attention(
        params_from_jax(p, "cpu"), tcfg, torch.from_numpy(x).to(tcfg.dtype),
        torch.from_numpy(pos).long(), causal=False,
        cross_kv=(to_torch(np.asarray(kb)), to_torch(np.asarray(vb))))
    assert cache is None
    assert seen == [f"_sdpa_{path}"] * 2
    _close(got, want, 1e-5 if dt == "f32" else 2e-2)


def test_non_causal_pass_takes_the_dense_path(donor, monkeypatch):
    """The encoder's full-sequence pass (no positions, not causal) stays
    on the dense path past the threshold, as the reference's."""
    jcfg, tcfg = _cfgs()
    monkeypatch.setattr(ja, "_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(ta, "_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(ta, "_sdpa_chunked", None)
    p = jax.tree.map(lambda a: a[0], donor["encoder"]["blocks"]["sub0"]
                     ["attn"])
    x = np.random.default_rng(4).standard_normal((B, 16, 64)) \
        .astype(np.float32)
    want, jc = ja.attention(jax.tree.map(jnp.asarray, p), jcfg, CTX,
                            jnp.asarray(x), None, causal=False)
    got, tc = ta.attention(params_from_jax(p, "cpu"), tcfg,
                           torch.from_numpy(x), None, causal=False)
    _close(got, want, 1e-5)
    _close(tc["k"], jc["k"], 2.0 ** -7)


# -- the encoder, loss, prefill, decode ------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encoder_and_cross_kv_match_reference(dt, donor):
    jcfg, tcfg = _cfgs(dt)
    jm, tm = j_build(jcfg), t_build(tcfg)
    mem = _batch(jcfg)["memory"]
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    jenc = jm._run_encoder(jp, CTX, jnp.asarray(mem))
    with torch.no_grad():
        tenc = tm._run_encoder(tp, torch.from_numpy(mem))
    assert tenc.dtype == tcfg.dtype
    _close(tenc, jenc, 1e-5 if dt == "f32" else 2e-2)
    jkv = jm._cross_kv_from_memory(jp, CTX, jenc)
    with torch.no_grad():
        tkv = tm._cross_kv_from_memory(tp, tenc)
    for n in ("k", "v"):
        assert tkv[n].dtype == torch.bfloat16
        assert tuple(tkv[n].shape) == jkv[n].shape == (2, B, 16, 4, 16)
        _close(tkv[n], jkv[n], 2.0 ** -7 if dt == "f32" else 2e-2)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(dt, donor):
    """``loss`` (the encoder, the cross K/V, the decoder, LayerNorm and
    GELU, sinusoidal positions); in float32 every gradient too."""
    jcfg, tcfg = _cfgs(dt)
    batch = _batch(jcfg)
    jm = j_build(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    if dt == "bf16":
        jl_, jmet = jm.loss(jp, _jb(batch), CTX)
        with torch.no_grad():
            tl_, tmet = t_build(tcfg).loss(tp, _tb(batch))
        np.testing.assert_allclose(float(tl_), float(jl_), rtol=2e-2)
        return
    (jl_, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(batch), CTX), has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl_, tmet = t_build(tcfg).loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=1e-5)
    for n in ("ce", "z"):
        np.testing.assert_allclose(float(tmet[n].detach()), float(jmet[n]),
                                   rtol=1e-5)
    tg = dict(zip(_flat(tp), torch.autograd.grad(tl_, leaves)))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    for k, want in jflat.items():
        _close(tg[k], want, 1e-4)


def test_loss_does_not_depend_on_the_remat_policy(donor):
    """The encoder blocks and the units (their cross K/V passed in) under
    each policy: the same loss and gradients, bit for bit."""
    batch = _tb(_batch(j_smoke(ARCH)))
    got = {}
    for policy in ("none", "dots", "full"):
        cfg = dataclasses.replace(t_smoke(ARCH), dtype=torch.float32,
                                  remat_policy=policy)
        p = tree_map(lambda t: t.requires_grad_(),
                     params_from_jax(donor, "cpu"))
        leaves = tree_leaves(p)
        loss, _ = t_build(cfg).loss(p, batch)
        got[policy] = (float(loss.detach()),
                       torch.autograd.grad(loss, leaves))
    for policy in ("dots", "full"):
        assert got[policy][0] == got["none"][0]
        for a, b in zip(got[policy][1], got["none"][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dt, donor):
    """A 12-token prompt with its 16 frames at B = 2, then four decode
    steps against the prefill's ``cross_kv``, each from the reference's
    cache."""
    jcfg, tcfg = _cfgs(dt)
    jm = j_build(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    batch = {k: v for k, v in _batch(jcfg).items()
             if k in ("tokens", "memory")}
    jl_, jc = jm.prefill(jp, _jb(batch), CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, _tb(batch))
    _close(tl_, jl_, 1e-5 if dt == "f32" else 2e-2)
    assert sorted(tc) == sorted(jc) == ["cross_kv", "layers", "pos"]
    assert tc["pos"] == int(jc["pos"]) == S
    kv_tol = 2.0 ** -7 if dt == "f32" else 2e-2
    for n in ("k", "v"):
        _close(tc["cross_kv"][n], jc["cross_kv"][n], kv_tol)
    step = make_decode_step(tcfg)
    for _ in range(4):
        for n in ("k", "v"):
            _close(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n], kv_tol)
        tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                     jc["layers"]),
              "cross_kv": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                       jc["cross_kv"]),
              "pos": int(jc["pos"])}
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None].astype(np.int32)
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, tc, torch.from_numpy(tok).long())
        _close(tl_[:, :jcfg.vocab], jl_[:, :jcfg.vocab],
               1e-4 if dt == "f32" else 2e-2)
    assert tc["pos"] == int(jc["pos"]) == S + 4
    assert tc["cross_kv"]["k"] is not None


def test_decode_replays_the_prefill(donor):
    """The port against itself: the prefill's last logits against a
    decode replay of its prompt from an empty 32-slot cache holding the
    prefill's ``cross_kv``.  The replay attends to the bfloat16 KV cache
    where the prefill attends to its float32 K/V, so the logits agree
    within 2e-2 of the largest, the argmax equal (as the dense family's
    replay test holds them)."""
    tcfg = _cfgs()[1]
    tm, tp = t_build(tcfg), params_from_jax(donor, "cpu")
    batch = _tb({k: v for k, v in _batch(j_smoke(ARCH)).items()
                 if k in ("tokens", "memory")})
    with torch.no_grad():
        want, pre = tm.prefill(tp, batch)
        cache = materialize(tm.cache_specs(B, 32), 0, device="cpu")
        cache["pos"], cache["cross_kv"] = 0, pre["cross_kv"]
        for t in range(S):
            got, cache = tm.decode_step(tp, cache,
                                        batch["tokens"][:, t:t + 1])
    assert cache["pos"] == pre["pos"] == S
    _close(got, want, 2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


# -- the launchers ---------------------------------------------------------


def _args(*extra):
    return ["--arch", ARCH, "--device", "cpu", "--steps", "6", "--seq", "24",
            "--batch", "2", "--ckpt-every", "2", "--log-every", "100",
            *map(str, extra)]


def test_trainer_batches_match_reference():
    """The trainer's batches are the reference trainer's: the seeded
    corpus with ``encoder_len`` frames of ``memory``."""
    cfg = t_smoke(ARCH)
    args = ttrain.parse_args(_args())
    got = ttrain.batch_source(cfg, args)
    ref = JSyntheticLM(vocab=cfg.vocab, seq_len=24, global_batch=2,
                       memory_len=cfg.encoder_len, img_tokens=0,
                       d_model=cfg.d_model)
    for step in (0, 3):
        g, w = got(step), ref.batch(step)
        assert sorted(g) == sorted(w) == ["labels", "loss_mask", "memory",
                                          "tokens"]
        assert g["memory"].shape == (2, 16, 64)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_trainer_restart_ends_bit_equal(tmp_path, capsys):
    got = ttrain.main(_args("--ckpt-dir", tmp_path / "a", "--fail-at", 3))
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "restarts=1" in out
    clean = ttrain.main(_args("--ckpt-dir", tmp_path / "b"))
    assert got["step"] == clean["step"] == 6
    assert all(np.isfinite(got["losses"]))
    for a, b in zip(tree_leaves({"p": got["params"], "o": got["opt"]}),
                    tree_leaves({"p": clean["params"], "o": clean["opt"]})):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engine_serves_the_reference_tokens():
    """Three requests of 6 new tokens over 2 slots, decoded against the
    all-zero ``cross_kv`` of ``cache_specs`` in both engines."""
    jcfg = j_smoke(ARCH)
    with hash_free_engines():
        jeng = js.Engine(jcfg, max_len=64, slots=2)
    jreqs = js._make_requests(jcfg, 3, 6, None, 0)
    jstats = jeng.run(jreqs)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    tcfg = t_smoke(ARCH)
    teng = ts.Engine(tcfg, 64, 2, device="cpu", params=params)
    assert sorted(teng.cache) == ["cross_kv", "layers", "pos"]
    treqs = ts.make_requests(tcfg, 3, 6, 0)
    tstats = teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tstats["served"] == jstats["served"] == 3
    assert not teng.cache["cross_kv"]["k"].any()


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_serve_cli_refuses_the_family(arch):
    with pytest.raises(SystemExit, match="serve demo targets text decoder "
                                         "archs"):
        ts.main(["--arch", arch, "--device", "cpu"])


# -- the checkpoint layout -------------------------------------------------


def test_checkpoint_layout_is_shared_with_the_reference(tmp_path, donor):
    """whisper's parameter tree (the encoder, the cross blocks, the
    LayerNorm biases) saved by either package restores in the other."""
    jparams = jax.tree.map(jnp.asarray, donor)
    jck.save(str(tmp_path / "j"), 3, {"params": jparams})
    like = {"params": materialize(t_build(t_smoke(ARCH)).param_specs(), 1,
                                  device="cpu")}
    got, _ = restore(str(tmp_path / "j"), 3, like, device="cpu")
    jflat = dict(zip(jck._paths({"params": jparams}),
                     jax.tree.leaves({"params": jparams})))
    tflat = dict(tck._flatten(got))
    assert list(tflat) == list(jflat)
    assert any("/encoder/" in k for k in tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v))
    save(str(tmp_path / "t"), 4, like)
    back, _ = jck.restore(str(tmp_path / "t"), 4, {"params": jparams})
    lflat = dict(tck._flatten(like))
    for name, v in zip(jck._paths(back), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(v), lflat[name].numpy())
