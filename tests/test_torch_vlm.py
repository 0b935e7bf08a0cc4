"""Port parity of the vlm family (llava) at its smoke config (2 layers, d
64, 4 heads over 2 KV heads, head_dim 16, a window of 32, 8 stub image
tokens), against ``repro.models.transformer``.

Both packages compute on the same donor weights (``jax_donor``).
Tolerances:

* the projector (``gelu(w1)``, then ``w2``): float32 1e-6 of the largest
  output; bfloat16 one bfloat16 rounding (2**-7 of the largest);
* whole models in float32 compute (``dataclasses.replace(cfg,
  dtype=float32)``): 1e-5 of the largest value for the loss and the
  prefill logits; 1e-4 for the gradients' entries and for decode logits
  (they attend to the bfloat16 KV cache: a value rounding to the
  neighbouring bfloat16 moves them by ~3e-5); the bfloat16 caches within
  one bfloat16 step (2**-7 of the largest); the port's decode after a
  prefill against the prefill of one token more within 2e-2 (the decode
  attends to the bfloat16 cache);
* bfloat16 compute (the config's own): within 2e-2 of the largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_smoke_config as j_smoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as js
from repro.models import build_model as j_build
from repro.nn.layers import Ctx
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_torch, tree_leaves
from repro_torch.launch import serve as ts
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model as t_build
from repro_torch.nn.module import materialize
from test_torch_donor import hash_free_engines, jax_donor

ARCH = "llava-next-mistral-7b"
CTX = Ctx()
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, N_IMG = 2, 10, 8


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
    """The donor, with the projector's zero biases replaced by seeded
    values so that they count."""
    p = jax.tree.map(np.asarray, jax_donor(
        j_build(_cfgs()[0]).param_specs(), 0))
    rng = np.random.default_rng(9)
    for w in ("w1", "w2"):
        p["projector"][w]["bias"] = (0.1 * rng.standard_normal(64)) \
            .astype(np.float32)
    return p


def _batch(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
            "loss_mask": (rng.uniform(size=(B, s)) > 0.2).astype(np.float32),
            "img_embeds": rng.standard_normal(
                (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_param_and_cache_specs_match_reference():
    def shapes(tree):
        return {k: tuple(v.shape) for k, v in _flat(tree).items()}

    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    assert shapes(tm.param_specs()) == shapes(jm.param_specs())
    assert sorted(tm.param_specs()["projector"]["w1"]) == ["bias", "kernel"]
    # the window bounds the cache: T = min(max_len, 32)
    for max_len in (16, 64):
        assert shapes(tm.cache_specs(3, max_len)) == \
            shapes(jm.cache_specs(3, max_len))
    assert tm.cache_specs(3, 64)["layers"]["sub0"]["k"].shape[2] == 32


# -- the fusion ------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_projector_and_fusion_match_reference(dt, donor):
    """``_embed``: the projected image first, then the text embeddings;
    without image embeddings the text alone."""
    jcfg, tcfg = _cfgs(dt)
    batch = _batch(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    want = j_build(jcfg)._embed(jp, CTX, jnp.asarray(batch["tokens"]),
                                jnp.asarray(batch["img_embeds"]))
    with torch.no_grad():
        got = t_build(tcfg)._embed(tp, torch.from_numpy(batch["tokens"]),
                                   torch.from_numpy(batch["img_embeds"]))
    assert got.shape == (B, N_IMG + S, 64) and got.dtype == tcfg.dtype
    _close(got[:, :N_IMG], want[:, :N_IMG], 1e-6 if dt == "f32" else 2.0 ** -7)
    np.testing.assert_array_equal(_np(got[:, N_IMG:]), _np(want[:, N_IMG:]))
    with torch.no_grad():
        text = t_build(tcfg)._embed(tp, torch.from_numpy(batch["tokens"]))
    assert text.shape == (B, S, 64)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(dt, donor):
    """``loss`` over the text positions (``x[:, -S:]``) after the fused
    image; in float32 every gradient too, the projector's included."""
    jcfg, tcfg = _cfgs(dt)
    batch = _batch(jcfg)
    jm = j_build(jcfg)
    jp = jax.tree.map(jnp.asarray, donor)
    tp = params_from_jax(donor, "cpu")
    tol = 1e-5 if dt == "f32" else 2e-2
    if dt == "bf16":
        jl_, jmet = jm.loss(jp, _jb(batch), CTX)
        with torch.no_grad():
            tl_, tmet = t_build(tcfg).loss(tp, _tb(batch))
        np.testing.assert_allclose(float(tl_), float(jl_), rtol=tol)
        return
    (jl_, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(batch), CTX), has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl_, tmet = t_build(tcfg).loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=tol)
    for n in ("ce", "z"):
        np.testing.assert_allclose(float(tmet[n].detach()), float(jmet[n]),
                                   rtol=tol)
    tg = dict(zip(_flat(tp), torch.autograd.grad(tl_, leaves)))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(tg)
    assert float(tg["/projector/w1/kernel"].abs().max()) > 0
    for k, want in jflat.items():
        _close(tg[k], want, 1e-4)


def test_loss_without_text_raises(donor):
    """No text after the image: the port names the cause; the reference
    fails with a ValueError too (its ``x[:, -0:]`` keeps the image)."""
    jcfg, tcfg = _cfgs()
    batch = _batch(jcfg, s=0)
    with pytest.raises(ValueError, match="longer than 0 after the image"):
        t_build(tcfg).loss(params_from_jax(donor, "cpu"), _tb(batch))
    with pytest.raises(ValueError):
        j_build(jcfg).loss(jax.tree.map(jnp.asarray, donor), _jb(batch),
                           CTX)


# -- prefill and the rolling window ----------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dt, donor):
    """A prefill of 8 image and 10 text tokens at B = 2 (``pos`` = 18, an
    18-slot cache), then four decode steps from it, each from the
    reference's cache: the window's modulo addresses the prefill's 18
    slots, so the first step writes slot 0 in both packages."""
    jcfg, tcfg = _cfgs(dt)
    jm = j_build(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    batch = {k: v for k, v in _batch(jcfg).items()
             if k in ("tokens", "img_embeds")}
    jl_, jc = jm.prefill(jp, _jb(batch), CTX)
    with torch.no_grad():
        tl_, tc = make_prefill_step(tcfg)(tp, _tb(batch))
    _close(tl_, jl_, 1e-5 if dt == "f32" else 2e-2)
    assert sorted(tc) == sorted(jc) == ["layers", "pos"]
    assert tc["pos"] == int(jc["pos"]) == N_IMG + S
    kv_tol = 2.0 ** -7 if dt == "f32" else 2e-2
    step = make_decode_step(tcfg)
    for _ in range(4):
        for n in ("k", "v"):
            _close(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n], kv_tol)
        tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                     jc["layers"]), "pos": int(jc["pos"])}
        tok = np.asarray(jnp.argmax(jl_, -1))[:, None].astype(np.int32)
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, tc, torch.from_numpy(tok).long())
        _close(tl_[:, :jcfg.vocab], jl_[:, :jcfg.vocab],
               1e-4 if dt == "f32" else 2e-2)
    assert tc["pos"] == int(jc["pos"]) == N_IMG + S + 4


def test_rolling_window_wraps_as_the_reference(donor):
    """Decode steps from a full 32-slot window cache (seeded K/V, ``pos``
    28) past its end: slots 28..31, then 0..3 are overwritten, every slot
    attended; logits and caches against the reference step by step."""
    jcfg, tcfg = _cfgs()
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp, tp = jax.tree.map(jnp.asarray, donor), params_from_jax(donor, "cpu")
    rng = np.random.default_rng(5)
    shape = tm.cache_specs(B, 64)["layers"]["sub0"]["k"].shape
    assert shape[2] == 32
    kv = {n: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
          for n in ("k", "v")}
    jc = {"layers": {"sub0": kv}, "pos": jnp.asarray(28, jnp.int32)}
    tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                 jc["layers"]), "pos": 28}
    step = make_decode_step(tcfg)
    tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    for i in range(8):
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok), CTX)
        with torch.no_grad():
            tl_, tc = step(tp, tc, torch.from_numpy(tok).long())
        _close(tl_[:, :jcfg.vocab], jl_[:, :jcfg.vocab], 1e-4)
        for n in ("k", "v"):
            _close(tc["layers"]["sub0"][n], jc["layers"]["sub0"][n],
                   2.0 ** -7)
        slot = (28 + i) % 32
        assert not torch.equal(tc["layers"]["sub0"]["k"][:, :, slot],
                               to_torch(np.asarray(kv["k"]))[:, :, slot])
        tc = {"layers": jax.tree.map(lambda a: to_torch(np.asarray(a)),
                                     jc["layers"]), "pos": int(jc["pos"])}
        tok = np.asarray(jnp.argmax(jl_[:, :jcfg.vocab], -1))[:, None] \
            .astype(np.int32)
    assert tc["pos"] == 36


def test_decode_in_a_window_cache_after_a_prefill(donor):
    """The port against itself, as the card's check runs it: the prefill's
    K/V copied into the first slots of a 32-slot window cache, one decode
    step on the next text token, against the last logits of the prefill
    of one token more (2e-2 of the largest, argmax equal)."""
    tcfg = _cfgs()[1]
    tm, tp = t_build(tcfg), params_from_jax(donor, "cpu")
    batch = _tb({k: v for k, v in _batch(j_smoke(ARCH), s=S + 1).items()
                 if k in ("tokens", "img_embeds")})
    short = dict(batch, tokens=batch["tokens"][:, :S])
    with torch.no_grad():
        want, _ = tm.prefill(tp, batch)
        _, pre = tm.prefill(tp, short)
        cache = materialize(tm.cache_specs(B, 64), 0, device="cpu")
        n = pre["pos"]
        for name in ("k", "v"):
            cache["layers"]["sub0"][name][:, :, :n] = \
                pre["layers"]["sub0"][name]
        cache["pos"] = n
        got, cache = tm.decode_step(tp, cache, batch["tokens"][:, S:])
    assert cache["pos"] == N_IMG + S + 1
    _close(got, want, 2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


# -- the launchers and the checkpoint layout -------------------------------


def _args(*extra):
    return ["--arch", ARCH, "--device", "cpu", "--steps", "6", "--seq", "24",
            "--batch", "2", "--ckpt-every", "2", "--log-every", "100",
            *map(str, extra)]


def test_trainer_batches_match_reference():
    """The reference trainer's ``batch_for``: the corpus at ``--seq`` with
    the image stubs, tokens, labels and mask cut to ``seq - n_img``."""
    cfg = t_smoke(ARCH)
    got = ttrain.batch_source(cfg, ttrain.parse_args(_args()))
    ref = JSyntheticLM(vocab=cfg.vocab, seq_len=24, global_batch=2,
                       memory_len=0, img_tokens=N_IMG, d_model=cfg.d_model)
    for step in (0, 5):
        g, w = got(step), dict(ref.batch(step))
        for k in ("tokens", "labels", "loss_mask"):
            w[k] = w[k][:, :24 - N_IMG]
        assert sorted(g) == sorted(w) == ["img_embeds", "labels",
                                          "loss_mask", "tokens"]
        assert g["tokens"].shape == (2, 16)
        assert g["img_embeds"].shape == (2, N_IMG, 64)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("seq", [N_IMG, 4])
def test_trainer_refuses_a_seq_without_text(seq, tmp_path):
    with pytest.raises(ValueError, match="leaves no text"):
        ttrain.main(["--arch", ARCH, "--device", "cpu", "--seq", str(seq),
                     "--ckpt-dir", str(tmp_path)])


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
    """Text only: three requests of 8 new tokens over 2 slots through the
    32-slot rolling window (``pos`` passes 32), the same tokens as the
    JAX engine on the same parameters."""
    jcfg = j_smoke(ARCH)
    with hash_free_engines():
        jeng = js.Engine(jcfg, max_len=64, slots=2)
    jreqs = js._make_requests(jcfg, 3, 8, None, 0)
    jstats = jeng.run(jreqs)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    tcfg = t_smoke(ARCH)
    teng = ts.Engine(tcfg, 64, 2, device="cpu", params=params)
    treqs = ts.make_requests(tcfg, 3, 8, 0)
    tstats = teng.run(treqs)
    assert teng.cache["pos"] > 32
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tstats["served"] == jstats["served"] == 3


def test_checkpoint_layout_is_shared_with_the_reference(tmp_path, donor):
    """llava's parameter tree (the projector's weights and biases) saved
    by either package restores in the other."""
    jparams = jax.tree.map(jnp.asarray, donor)
    jck.save(str(tmp_path / "j"), 3, {"params": jparams})
    like = {"params": materialize(t_build(t_smoke(ARCH)).param_specs(), 1,
                                  device="cpu")}
    got, _ = restore(str(tmp_path / "j"), 3, like, device="cpu")
    jflat = dict(zip(jck._paths({"params": jparams}),
                     jax.tree.leaves({"params": jparams})))
    tflat = dict(tck._flatten(got))
    assert list(tflat) == list(jflat)
    assert any("/projector/" in k for k in tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v))
    save(str(tmp_path / "t"), 4, like)
    back, _ = jck.restore(str(tmp_path / "t"), 4, {"params": jparams})
    lflat = dict(tck._flatten(like))
    for name, v in zip(jck._paths(back), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(v), lflat[name].numpy())
