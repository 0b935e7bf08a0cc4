"""Decoder-only transformer, the dense family (port of
``repro.models.transformer``).

Layers are stored stacked in units ``sub{i}`` (``[L, ...]`` per parameter,
as the reference scans them; a dense model's unit is one block), and
:meth:`TransformerLM.loss`, :meth:`TransformerLM.prefill` and
:meth:`TransformerLM.decode_step` walk the stack with a Python loop over
layer views, as ``models/mamba.py`` does.  The KV cache is ``{"layers":
{"sub0": {"k", "v" [L, B, T, Hk, Dh]}}, "pos"}``, bfloat16, with ``pos``
(the next write position) a host int.

Training: :meth:`TransformerLM.loss` applies ``cfg.remat_policy`` to each
block (``nn.module.remat``) and :func:`chunked_ce_loss` checkpoints each
vocabulary-loss chunk, as the reference's ``jax.checkpoint`` does.

Not ported yet: the ``moe``, ``audio`` and ``vlm`` families (MoE blocks,
cross-attention, the encoder, image tokens), which raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.attention import attention, attention_spec, init_cache_specs
from repro_torch.nn.layers import (dense, dense_spec, embed, embed_spec,
                                   rmsnorm, rmsnorm_spec)
from repro_torch.nn.module import ParamSpec, layer_view, remat, stack_specs

__all__ = ["TransformerLM", "mlp_spec", "mlp", "block_spec", "block_apply",
           "chunked_ce_loss"]


def mlp_spec(cfg, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_spec(d, f, dtype=dtype),
            "wu": dense_spec(d, f, dtype=dtype),
            "wd": dense_spec(f, d, dtype=dtype)}


def mlp(params, cfg, x):
    """The gated SiLU MLP in ``cfg.dtype``."""
    g = dense(params["wg"], x, cfg.dtype)
    u = dense(params["wu"], x, cfg.dtype)
    return dense(params["wd"], F.silu(g) * u, cfg.dtype)


def block_spec(cfg, *, dtype=torch.float32):
    return {"ln_attn": rmsnorm_spec(cfg.d_model, dtype),
            "attn": attention_spec(cfg, dtype=dtype),
            "ln_mlp": rmsnorm_spec(cfg.d_model, dtype),
            "mlp": mlp_spec(cfg, dtype)}


def block_apply(params, cfg, x, positions, *,
                cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """One pre-norm causal block: ``(x, cache)`` as :func:`attention`
    returns the cache."""
    h, new_cache = attention(params["attn"], cfg,
                             rmsnorm(params["ln_attn"], x, cfg.norm_eps),
                             positions, cache=cache)
    x = x + h
    h = mlp(params["mlp"], cfg, rmsnorm(params["ln_mlp"], x, cfg.norm_eps))
    return x + h, new_cache


def chunked_ce_loss(logits_fn, x, labels, mask, chunk: int):
    """Cross-entropy and z-loss (``logsumexp**2``), both summed over the
    masked tokens and divided by ``max(mask.sum(), 1)``, over sequence
    chunks so that only one chunk's ``[B, c, V]`` float32 logits exist at a
    time.

    ``logits_fn`` maps ``[B, c, d]`` to ``[B, c, V]`` (the head); ``x [B, S,
    d]``, ``labels [B, S]``, ``mask [B, S]`` float32.  ``c`` is ``chunk``
    (``0``: one chunk) stepped down until it divides ``S``; with more than
    one chunk each chunk is checkpointed, so its logits are recomputed in
    the backward pass instead of kept.  Returns ``(ce, z)``."""
    B, S, d = x.shape
    c = min(chunk, S) if chunk else S
    while S % c:
        c -= 1
    n = S // c

    def chunk_loss(xc, lc, mc):
        logits = logits_fn(xc).float()  # [B, c, V]
        lse = torch.logsumexp(logits, -1)
        gold = torch.take_along_dim(logits, lc[..., None].long(), -1)[..., 0]
        ce = (lse - gold) * mc
        z = torch.square(lse) * mc
        return ce.sum(), z.sum()

    if n == 1:
        ce, z = chunk_loss(x, labels, mask)
    else:
        body = remat(chunk_loss, "full")
        ce = z = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            s = slice(i * c, (i + 1) * c)
            ce_i, z_i = body(x[:, s], labels[:, s], mask[:, s])
            ce, z = ce + ce_i, z + z_i
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce / denom, z / denom


@dataclasses.dataclass
class TransformerLM:
    """Param specs + loss / prefill / decode for one dense config."""

    cfg: Any

    def __post_init__(self):
        if self.cfg.family != "dense":  # moe, audio and vlm
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (dense is)")

    def param_specs(self):
        cfg = self.cfg
        p = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                 cfg.param_dtype),
             "blocks": stack_specs(
                 {"sub0": block_spec(cfg, dtype=cfg.param_dtype)},
                 cfg.n_layers),
             "ln_f": rmsnorm_spec(cfg.d_model, cfg.param_dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"kernel": ParamSpec(
                (cfg.d_model, cfg.padded_vocab), cfg.param_dtype, "fan_in")}
        return p

    def cache_specs(self, batch: int, max_len: int):
        """The decode cache's specs; ``pos`` materializes as a 0-d tensor,
        which a caller may replace by a host int (the engine does)."""
        cfg = self.cfg
        per_unit = {"sub0": init_cache_specs(cfg, batch, max_len, 1,
                                             layer_axis=False)}
        return {"layers": stack_specs(per_unit, cfg.n_layers),
                "pos": ParamSpec((), torch.int32, "zeros")}

    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            return x @ params["embed"]["embedding"].to(cfg.dtype).T
        return dense(params["lm_head"], x, cfg.dtype)

    def _run_blocks(self, params, x, positions, caches=None, cache_pos=None):
        """The layers in order.  Returns ``(x, caches)``: with ``caches``
        (stacked decode KV) each layer's step against its view of them,
        else each layer's full-sequence K/V; both stacked ``[L, ...]``."""
        ks, vs = [], []
        for l in range(self.cfg.n_layers):
            p = layer_view(params["blocks"], l)["sub0"]
            cache_in = None
            if caches is not None:
                cache_in = {"k": caches["sub0"]["k"][l],
                            "v": caches["sub0"]["v"][l], "pos": cache_pos}
            x, nc = block_apply(p, self.cfg, x, positions, cache=cache_in)
            ks.append(nc["k"])
            vs.append(nc["v"])
        return x, {"sub0": {"k": torch.stack(ks), "v": torch.stack(vs)}}

    def loss(self, params, batch):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``): ``(ce + 1e-4 * z, {"ce", "z"})``.  Each
        block runs under ``cfg.remat_policy``; the values do not depend on
        it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

        def blk(x, p):
            return block_apply(p, cfg, x, positions)[0]

        blk = remat(blk, cfg.remat_policy)
        for l in range(cfg.n_layers):
            x = blk(x, layer_view(params["blocks"], l)["sub0"])
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        ce, z = chunked_ce_loss(lambda xc: self._logits(params, xc), x,
                                labels, mask.float(), cfg.loss_chunk)
        return ce + 1e-4 * z, {"ce": ce, "z": z}

    def prefill(self, params, batch):
        """Full-sequence forward over ``batch["tokens"] [B, S]``: the last
        position's logits ``[B, Vp]`` and the decode-ready cache (``pos``
        = S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, layer_caches = self._run_blocks(params, x, positions)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._logits(params, x[:, -1:])[:, 0]
        return logits, {"layers": layer_caches, "pos": S}

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """tokens ``[B, 1]``; cache ``{"layers", "pos"}`` -> ``(logits
        [B, Vp], new cache)`` with ``pos + 1`` (new K/V tensors; the given
        cache is not changed)."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(cache["pos"])
        x = embed(params["embed"], tokens, cfg.dtype)
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
        x, new_layers = self._run_blocks(params, x, positions,
                                         caches=cache["layers"],
                                         cache_pos=pos)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._logits(params, x)[:, -1]
        return logits, dict(cache, layers=new_layers, pos=pos + 1)
