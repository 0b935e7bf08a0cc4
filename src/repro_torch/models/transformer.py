"""Decoder-only transformer, the dense and MoE families (port of
``repro.models.transformer``).

Layers are stored stacked in units of ``cfg.moe.interleave`` blocks
(``sub0`` .. ``sub{u-1}``, ``[n_units, ...]`` per parameter, as the
reference scans them; the MoE block is the unit's last, so granite is MoE
every layer and llama4 alternates dense and MoE; a dense model's unit is
one block), and :meth:`TransformerLM.loss`, :meth:`TransformerLM.prefill`
and :meth:`TransformerLM.decode_step` walk the units with a Python loop
over layer views, as ``models/mamba.py`` does.  The KV cache is
``{"layers": {"sub{i}": {"k", "v" [n_units, B, T, Hk, Dh]}}, "pos"}``,
bfloat16, with ``pos`` (the next write position) a host int.

An MoE block routes its tokens through ``nn.moe`` (plus the always-on
``shared_mlp`` where the config has a shared expert); the loss adds the
routers' load-balance and z losses, averaged over the units, and reports
them in its metrics.

Training: :meth:`TransformerLM.loss` applies ``cfg.remat_policy`` to each
unit (``nn.module.remat``) and :func:`chunked_ce_loss` checkpoints each
vocabulary-loss chunk, as the reference's ``jax.checkpoint`` does.

Not ported yet: the ``audio`` and ``vlm`` families (cross-attention, the
encoder, image tokens), which raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.attention import attention, attention_spec, init_cache_specs
from repro_torch.nn.layers import (dense, dense_spec, embed, embed_spec,
                                   rmsnorm, rmsnorm_spec)
from repro_torch.nn.moe import moe_apply, moe_spec
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


def block_spec(cfg, use_moe: bool = False, *, dtype=torch.float32):
    p = {"ln_attn": rmsnorm_spec(cfg.d_model, dtype),
         "attn": attention_spec(cfg, dtype=dtype),
         "ln_mlp": rmsnorm_spec(cfg.d_model, dtype)}
    if use_moe:
        p["moe"] = moe_spec(cfg, dtype)
        if cfg.moe.shared_expert:
            p["shared_mlp"] = mlp_spec(cfg, dtype)
    else:
        p["mlp"] = mlp_spec(cfg, dtype)
    return p


def block_apply(params, cfg, x, positions, *,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One pre-norm causal block: ``(x, cache, aux)``, the cache as
    :func:`attention` returns it and ``aux`` the router losses of an MoE
    block (empty for a dense one)."""
    aux = {}
    h, new_cache = attention(params["attn"], cfg,
                             rmsnorm(params["ln_attn"], x, cfg.norm_eps),
                             positions, cache=cache)
    x = x + h
    xn = rmsnorm(params["ln_mlp"], x, cfg.norm_eps)
    if "moe" in params:
        h, aux = moe_apply(params["moe"], cfg, xn)
        if "shared_mlp" in params:
            h = h + mlp(params["shared_mlp"], cfg, xn)
    else:
        h = mlp(params["mlp"], cfg, xn)
    return x + h, new_cache, aux


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
    """Param specs + loss / prefill / decode for one dense or MoE config."""

    cfg: Any

    def __post_init__(self):
        if self.cfg.family not in ("dense", "moe"):  # audio and vlm
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (dense and "
                f"moe are)")

    def _unit_size(self) -> int:
        return self.cfg.moe.interleave if self.cfg.moe else 1

    def _n_units(self) -> int:
        u = self._unit_size()
        if self.cfg.n_layers % u:
            raise ValueError(
                f"n_layers {self.cfg.n_layers} is not a multiple of the MoE "
                f"interleave unit size {u}")
        return self.cfg.n_layers // u

    def _unit_spec(self):
        cfg, u = self.cfg, self._unit_size()
        return {f"sub{i}": block_spec(
            cfg, cfg.moe is not None and i == u - 1, dtype=cfg.param_dtype)
            for i in range(u)}

    def param_specs(self):
        cfg = self.cfg
        p = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                 cfg.param_dtype),
             "blocks": stack_specs(self._unit_spec(), self._n_units()),
             "ln_f": rmsnorm_spec(cfg.d_model, cfg.param_dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"kernel": ParamSpec(
                (cfg.d_model, cfg.padded_vocab), cfg.param_dtype, "fan_in")}
        return p

    def cache_specs(self, batch: int, max_len: int):
        """The decode cache's specs; ``pos`` materializes as a 0-d tensor,
        which a caller may replace by a host int (the engine does)."""
        cfg = self.cfg
        per_unit = {f"sub{i}": init_cache_specs(cfg, batch, max_len, 1,
                                                layer_axis=False)
                    for i in range(self._unit_size())}
        return {"layers": stack_specs(per_unit, self._n_units()),
                "pos": ParamSpec((), torch.int32, "zeros")}

    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            return x @ params["embed"]["embedding"].to(cfg.dtype).T
        return dense(params["lm_head"], x, cfg.dtype)

    def _unit(self, p, x, positions, cache_u=None, cache_pos=None):
        """One unit's blocks in order: ``(x, {sub: cache}, aux summed over
        the unit)``."""
        new_cache = {}
        aux = {"load_balance": torch.zeros((), device=x.device),
               "router_z": torch.zeros((), device=x.device)}
        for i in range(self._unit_size()):
            sub = f"sub{i}"
            cache_in = None
            if cache_u is not None:
                cache_in = dict(cache_u[sub], pos=cache_pos)
            x, nc, a = block_apply(p[sub], self.cfg, x, positions,
                                   cache=cache_in)
            new_cache[sub] = nc
            for n, v in a.items():
                aux[n] = aux[n] + v
        return x, new_cache, aux

    def _run_blocks(self, params, x, positions, caches=None, cache_pos=None):
        """The units in order.  Returns ``(x, caches, aux)``: with
        ``caches`` (stacked decode KV) each unit's step against its view of
        them, else each unit's full-sequence K/V, both stacked ``[n_units,
        ...]``; ``aux`` the router losses summed over the units."""
        kv = {f"sub{i}": ([], []) for i in range(self._unit_size())}
        aux = None
        for l in range(self._n_units()):
            cache_u = None if caches is None else layer_view(caches, l)
            x, nc, a = self._unit(layer_view(params["blocks"], l), x,
                                  positions, cache_u, cache_pos)
            aux = a if aux is None else {n: aux[n] + a[n] for n in aux}
            for sub, (ks, vs) in kv.items():
                ks.append(nc[sub]["k"])
                vs.append(nc[sub]["v"])
        return x, {sub: {"k": torch.stack(ks), "v": torch.stack(vs)}
                   for sub, (ks, vs) in kv.items()}, aux

    def loss(self, params, batch):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``): ``(ce + 1e-4 * z [+ the MoE aux losses],
        {"ce", "z", "load_balance", "router_z"})``; an MoE config adds
        ``1e-2 * load_balance / n_units + 1e-3 * router_z / n_units``.
        Each unit runs under ``cfg.remat_policy``; the values do not depend
        on it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

        def blk(x, p):
            x, _, a = self._unit(p, x, positions)
            return x, a["load_balance"], a["router_z"]

        blk = remat(blk, cfg.remat_policy)
        lb = rz = torch.zeros((), device=x.device)
        for l in range(self._n_units()):
            x, a_lb, a_rz = blk(x, layer_view(params["blocks"], l))
            lb, rz = lb + a_lb, rz + a_rz
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        ce, z = chunked_ce_loss(lambda xc: self._logits(params, xc), x,
                                labels, mask.float(), cfg.loss_chunk)
        loss = ce + 1e-4 * z
        if cfg.moe:
            loss = loss + 1e-2 * lb / self._n_units() \
                + 1e-3 * rz / self._n_units()
        return loss, {"ce": ce, "z": z, "load_balance": lb, "router_z": rz}

    def prefill(self, params, batch):
        """Full-sequence forward over ``batch["tokens"] [B, S]``: the last
        position's logits ``[B, Vp]`` and the decode-ready cache (``pos``
        = S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, layer_caches, _ = self._run_blocks(params, x, positions)
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
        x, new_layers, _ = self._run_blocks(params, x, positions,
                                         caches=cache["layers"],
                                         cache_pos=pos)
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._logits(params, x)[:, -1]
        return logits, dict(cache, layers=new_layers, pos=pos + 1)
