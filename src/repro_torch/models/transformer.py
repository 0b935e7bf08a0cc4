"""Transformers: decoder-only (the dense and MoE families), whisper's
encoder-decoder (audio) and llava's image-token fusion (vlm); port of
``repro.models.transformer``.

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
them in its metrics.  Under a mesh the MoE unit runs ``nn.moe``'s
expert-parallel schedules (all-to-all for a prefill or a loss, psum for a
decode step), each layer's aux averaged over its shards before the
units' sum.

The audio family (whisper) uses LayerNorm and a tanh GELU MLP with biases,
sinusoidal positions added to the embeddings, and an encoder of
non-causal blocks over the stub frame embeddings ``batch["memory"] [B, F,
d]``; each decoder block adds a cross-attention to per-layer K/V projected
from the encoder's output once (``cross_kv``, bfloat16, carried in the
decode cache).  The vlm family (llava) projects ``batch["img_embeds"]
[B, n_img_tokens, d]`` (``gelu(w1)``, then ``w2``) and places them before
the text; the loss is over the text positions only.

Training: :meth:`TransformerLM.loss` applies ``cfg.remat_policy`` to each
unit and encoder block (``nn.module.remat``) and :func:`chunked_ce_loss`
checkpoints each vocabulary-loss chunk, as the reference's
``jax.checkpoint`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn import coords
from repro_torch.nn.attention import attention, attention_spec, init_cache_specs
from repro_torch.nn.layers import (Rows, column_parallel, dense,
                                   dense_spec, embed, embed_spec, layernorm,
                                   layernorm_spec, rmsnorm, rmsnorm_spec,
                                   row_parallel_rows, sinusoidal_positions,
                                   vocab_embed, vocab_logits)
from repro_torch.nn.moe import moe_apply, moe_spec
from repro_torch.nn.module import (ParamSpec, Placed, layer_view, remat,
                                   stack_specs)

__all__ = ["TransformerLM", "mlp_spec", "mlp", "block_spec", "block_apply",
           "chunked_ce_loss", "mesh_ce_loss"]


def _use_ln(cfg) -> bool:
    return cfg.family == "audio"  # whisper: LayerNorm and GELU


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh form, step by step in
    ``x.dtype`` (each step rounded, as XLA rounds a bfloat16 one)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float64) \
        .to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def mlp_spec(cfg, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    if _use_ln(cfg):
        return {"wi": dense_spec(d, f, axes=("embed", "mlp"), bias=True,
                                 dtype=dtype),
                "wo": dense_spec(f, d, axes=("mlp", "embed"), bias=True,
                                 dtype=dtype)}
    return {"wg": dense_spec(d, f, axes=("embed", "mlp"), dtype=dtype),
            "wu": dense_spec(d, f, axes=("embed", "mlp"), dtype=dtype),
            "wd": dense_spec(f, d, axes=("mlp", "embed"), dtype=dtype)}


def mlp(params, cfg, x, *, ctx=None):
    """In ``cfg.dtype``: whisper's GELU MLP (``wi``, ``wo``, with biases),
    else the gated SiLU MLP.  Under a ``ctx`` with a mesh (``x`` a
    ``nn.layers.Rows``): the up projections column-parallel over the mlp
    columns, the down projection row-parallel."""
    if ctx is not None and ctx.mesh is not None:
        return _mlp_mesh(params, cfg, ctx, x)
    if "wi" in params:
        return dense(params["wo"], _gelu(dense(params["wi"], x, cfg.dtype)),
                     cfg.dtype)
    g = dense(params["wg"], x, cfg.dtype)
    u = dense(params["wu"], x, cfg.dtype)
    return dense(params["wd"], F.silu(g) * u, cfg.dtype)


def _mlp_mesh(params, cfg, ctx, xs):
    gelu = "wi" in params
    up, down = ("wi", "wo") if gelu else ("wg", "wd")
    wd = params[down]["kernel"]
    hs = {}
    for row, x in xs.items():
        a = column_parallel(ctx, row, params[up], x, cfg.dtype)
        if gelu:
            hs[row] = [(r, _gelu(t))
                       for _, (r, t) in zip(ctx.shards(row, len(a)), a)]
        else:
            u = column_parallel(ctx, row, params["wu"], x, cfg.dtype)
            hs[row] = [(r, F.silu(g) * h) for (r, g), (_, h) in zip(a, u)]

    # the gated MLP's wd takes row_parallel under explicit_rs, as the
    # reference's does (the GELU MLP's wo does not)
    _, S, f = next(iter(hs.values()))[0][1].shape
    rs = None if gelu else row_parallel_rows(
        ctx, hs, wd, "bsf,fd->bsd", (xs.batch, S, wd.shape[0]), cfg.dtype)

    def out(row, _):
        if rs is not None:
            y = rs[row]
        else:
            parts = [t.float() @ ctx.weight(wd, row, j).to(cfg.dtype).float()
                     for j, (_, t) in zip(ctx.shards(row, len(hs[row])),
                                          hs[row])]
            y = ctx.reduce(parts, row, cfg.dtype)
        if "bias" in params[down]:
            y = y + ctx.weight(params[down]["bias"], row, 0).to(
                y.device, cfg.dtype)
        return y

    return xs.map(out)


def _local(tree, ctx, row):
    """A tree of replicated placed leaves (norms) as ``row``'s first
    device's tensors."""
    if isinstance(tree, dict):
        return {k: _local(v, ctx, row) for k, v in tree.items()}
    return ctx.weight(tree, row, 0)


def block_spec(cfg, use_moe: bool = False, cross: bool = False, *,
               dtype=torch.float32):
    norm = layernorm_spec if _use_ln(cfg) else rmsnorm_spec
    p = {"ln_attn": norm(cfg.d_model, dtype),
         "attn": attention_spec(cfg, dtype=dtype),
         "ln_mlp": norm(cfg.d_model, dtype)}
    if cross:
        p["ln_cross"] = norm(cfg.d_model, dtype)
        p["cross"] = attention_spec(cfg, dtype=dtype)
    if use_moe:
        p["moe"] = moe_spec(cfg, dtype)
        if cfg.moe.shared_expert:
            p["shared_mlp"] = mlp_spec(cfg, dtype)
    else:
        p["mlp"] = mlp_spec(cfg, dtype)
    return p


def _norm(params, cfg, x, ctx=None):
    fn = layernorm if _use_ln(cfg) else rmsnorm
    if ctx is not None and ctx.mesh is not None:
        return x.map(lambda row, t: fn(_local(params, ctx, row), t,
                                       cfg.norm_eps))
    return fn(params, x, cfg.norm_eps)


def _add(a, b):
    """``a + b`` of tensors or of ``nn.layers.Rows``."""
    if isinstance(a, Rows):
        return a.map(lambda row, t: t + b[row])
    return a + b


def block_apply(params, cfg, x, positions, causal: bool = True,
                cache: Optional[Dict] = None, cross_kv=None, *, ctx=None
                ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One pre-norm block: ``(x, cache, aux)``, the cache as
    :func:`attention` returns it and ``aux`` the router losses of an MoE
    block (empty for a dense one).  ``cross_kv=(k, v)`` adds whisper's
    cross-attention after the self-attention.  Under a ``ctx`` with a mesh
    ``x`` and ``positions`` are ``nn.layers.Rows`` (the norms and the
    residual adds run on each row's first device); an MoE block runs
    ``moe_apply``'s expert-parallel schedules and its shared expert the
    mesh MLP, and its ``aux`` is averaged over the shards."""
    aux = {}
    h, new_cache = attention(params["attn"], cfg,
                             _norm(params["ln_attn"], cfg, x, ctx),
                             positions, causal=causal, cache=cache, ctx=ctx)
    x = _add(x, h)
    if cross_kv is not None:
        h, _ = attention(params["cross"], cfg,
                         _norm(params["ln_cross"], cfg, x, ctx), positions,
                         causal=False, cross_kv=cross_kv, ctx=ctx)
        x = _add(x, h)
    xn = _norm(params["ln_mlp"], cfg, x, ctx)
    if "moe" in params:
        h, aux = moe_apply(params["moe"], cfg, xn, ctx=ctx)
        if "shared_mlp" in params:
            h = _add(h, mlp(params["shared_mlp"], cfg, xn, ctx=ctx))
    else:
        h = mlp(params["mlp"], cfg, xn, ctx=ctx)
    return _add(x, h), new_cache, aux


def _ce_sums(lse_gold, x, labels, mask, chunk: int):
    """The masked sums of the cross-entropy and of z over sequence chunks
    (:func:`chunked_ce_loss`'s body): ``lse_gold(xc, lc)`` gives a chunk's
    float32 ``logsumexp`` and gold logit ``[B, c]``; ``(ce_sum, z_sum)``."""
    B, S, d = x.shape
    c = min(chunk, S) if chunk else S
    while S % c:
        c -= 1
    n = S // c

    def chunk_loss(xc, lc, mc):
        lse, gold = lse_gold(xc, lc)
        ce = (lse - gold) * mc
        z = torch.square(lse) * mc
        return ce.sum(), z.sum()

    if n == 1:
        return chunk_loss(x, labels, mask)
    body = remat(chunk_loss, "full")
    ce = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        s = slice(i * c, (i + 1) * c)
        ce_i, z_i = body(x[:, s], labels[:, s], mask[:, s])
        ce, z = ce + ce_i, z + z_i
    return ce, z


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
    def lse_gold(xc, lc):
        logits = logits_fn(xc).float()  # [B, c, V]
        return torch.logsumexp(logits, -1), torch.take_along_dim(
            logits, lc[..., None].long(), -1)[..., 0]

    ce, z = _ce_sums(lse_gold, x, labels, mask, chunk)
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce / denom, z / denom


def mesh_ce_loss(ctx, w, tied: bool, dtype, xs, labels, mask, chunk: int):
    """:func:`chunked_ce_loss` under a mesh, each row on its own batch
    block and model shards: ``xs`` the rows' final normed states
    (``nn.layers.Rows``), ``w`` the placed head (the tied ``[V, d]``
    embedding or an ``[d, V]`` kernel), ``labels``/``mask [B, S]`` whole.

    Each shard of a row computes its vocabulary block's logits of a chunk
    (its head block joined once for all the row's chunks), their float32
    ``logsumexp`` and the gold logit where the label falls in its block
    (zero elsewhere); the row's first device merges the shards'
    ``logsumexp`` by log-sum-exp and adds their gold logits (one nonzero a
    token, so the sum is exact), so no ``[b, c, V]`` tensor is joined
    anywhere.  Each row yields its masked sums of the cross-entropy and z
    and its mask count; the rows' partials are added in float32 in row
    order on the mesh's first device and divided once there.  Returns
    ``(ce, z)``."""
    labels_r, mask_r = ctx.split_rows(labels), ctx.split_rows(mask)
    ces, zs, ns = [], [], []
    for row, x in xs.items():
        # the row's head blocks [d, V / n], each joined (FSDP) once for all
        # the row's chunks
        ws = [ctx.weight(w, row, j).to(dtype)
              for j in ctx.shards(row, ctx.splits(w, 0 if tied else 1))]
        ws = [t.T if tied else t for t in ws]
        size = ws[0].shape[-1]

        def lse_gold(xc, lc, row=row, ws=ws):
            # each label's vocabulary block and its column there, [2, b, c]
            where = torch.stack([lc // size, lc % size]).long()
            outs = []
            for j, t in zip(ctx.shards(row, len(ws)), ws):
                lg = (xc.to(t.device) @ t).float()
                blk, col = where.to(t.device)
                gold = lg.gather(-1, col[..., None])[..., 0] * (blk == j)
                outs.append(torch.stack([torch.logsumexp(lg, -1), gold]))
            if len(outs) == 1:
                return outs[0][0], outs[0][1]
            dev = ctx.device(row)
            with ctx.at(row), coords.kind("all-reduce"):
                both = torch.stack([o.to(dev) for o in outs])  # [n, 2, b, c]
                return torch.logsumexp(both[:, 0], 0), both[:, 1].sum(0)

        m = mask_r[row]
        ce_r, z_r = _ce_sums(lse_gold, x, labels_r[row], m, chunk)
        ces.append(ce_r)
        zs.append(z_r)
        ns.append(m.sum())
    row0 = ctx.rows()[0]
    ce = ctx.reduce(ces, row0, torch.float32)
    z = ctx.reduce(zs, row0, torch.float32)
    n = ctx.reduce(ns, row0, torch.float32)
    with ctx.at(row0):
        denom = torch.clamp(n, min=1.0)
        return ce / denom, z / denom


def _cross_at(cross_kv, l):
    """Layer ``l``'s ``(k, v)`` of stacked cross K/V (None without)."""
    if cross_kv is None:
        return None
    return layer_view(cross_kv["k"], l), layer_view(cross_kv["v"], l)


@dataclasses.dataclass
class TransformerLM:
    """Param specs + loss / prefill / decode for one transformer config."""

    cfg: Any

    def _unit_size(self) -> int:
        return self.cfg.moe.interleave if self.cfg.moe else 1

    def _n_units(self) -> int:
        u = self._unit_size()
        if self.cfg.n_layers % u:
            raise ValueError(
                f"n_layers {self.cfg.n_layers} is not a multiple of the MoE "
                f"interleave unit size {u}")
        return self.cfg.n_layers // u

    def _unit_spec(self, cross=False):
        cfg, u = self.cfg, self._unit_size()
        return {f"sub{i}": block_spec(
            cfg, cfg.moe is not None and i == u - 1, cross,
            dtype=cfg.param_dtype)
            for i in range(u)}

    def param_specs(self):
        cfg = self.cfg
        norm = layernorm_spec if _use_ln(cfg) else rmsnorm_spec
        p = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                 cfg.param_dtype),
             "blocks": stack_specs(
                 self._unit_spec(cross=cfg.encoder_layers > 0),
                 self._n_units()),
             "ln_f": norm(cfg.d_model, cfg.param_dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"kernel": ParamSpec(
                (cfg.d_model, cfg.padded_vocab), cfg.param_dtype, "fan_in",
                axes=("embed", "vocab"))}
        if cfg.encoder_layers:
            p["encoder"] = {
                "blocks": stack_specs(
                    {"sub0": block_spec(cfg, dtype=cfg.param_dtype)},
                    cfg.encoder_layers),
                "ln_f": norm(cfg.d_model, cfg.param_dtype)}
        if cfg.n_img_tokens:
            d = cfg.d_model
            p["projector"] = {
                "w1": dense_spec(d, d, axes=("embed", "mlp"), bias=True,
                                 dtype=cfg.param_dtype),
                "w2": dense_spec(d, d, axes=("mlp", "embed"), bias=True,
                                 dtype=cfg.param_dtype)}
        return p

    def cache_specs(self, batch: int, max_len: int):
        """The decode cache's specs; ``pos`` materializes as a 0-d tensor,
        which a caller may replace by a host int (the engine does).
        whisper's adds ``cross_kv``: each decoder layer's cross K/V
        ``[n_units, batch, encoder_len, Hk, Dh]``, bfloat16 zeros until a
        prefill computes them."""
        cfg = self.cfg
        per_unit = {f"sub{i}": init_cache_specs(cfg, batch, max_len, 1,
                                                layer_axis=False)
                    for i in range(self._unit_size())}
        c = {"layers": stack_specs(per_unit, self._n_units()),
             "pos": ParamSpec((), torch.int32, "zeros", axes=())}
        if cfg.encoder_layers:
            shape = (self._n_units(), batch, cfg.encoder_len,
                     cfg.padded_kv_heads, cfg.resolved_head_dim)
            axes = ("layers", "batch", None, "kv_heads", None)
            c["cross_kv"] = {
                "k": ParamSpec(shape, torch.bfloat16, "zeros", axes=axes),
                "v": ParamSpec(shape, torch.bfloat16, "zeros", axes=axes)}
        return c

    def _mesh(self, ctx) -> bool:
        return ctx is not None and ctx.mesh is not None

    def _embed(self, params, tokens, img_embeds=None, ctx=None):
        """Token embeddings ``[B, S, d]`` in ``cfg.dtype``; with image
        embeddings (an image config), their projection placed first.
        Under a mesh the lookup is vocab-parallel: each shard's rows (ids
        outside its block give zeros) added in float32 on the row's first
        device, then cast."""
        cfg = self.cfg
        if not self._mesh(ctx):
            x = embed(params["embed"], tokens, cfg.dtype)
            if cfg.n_img_tokens and img_embeds is not None:
                h = _gelu(dense(params["projector"]["w1"], img_embeds,
                                cfg.dtype))
                img = dense(params["projector"]["w2"], h, cfg.dtype)
                x = torch.cat([img, x], 1)  # early fusion: the image first
            return x
        x = vocab_embed(ctx, params["embed"]["embedding"],
                        ctx.split_rows(tokens), cfg.dtype)
        if cfg.n_img_tokens and img_embeds is not None:
            proj = {"wi": params["projector"]["w1"],
                    "wo": params["projector"]["w2"]}
            img = _mlp_mesh(proj, cfg, ctx, ctx.split_rows(img_embeds))
            x = x.map(lambda row, t: torch.cat([img[row], t], 1))
        return x

    def _add_positions(self, x, offset=0):
        """``x`` plus the sinusoidal positions from ``offset`` (in
        ``cfg.dtype``) where the config uses them."""
        cfg = self.cfg
        if cfg.pos_embed != "sinusoidal":
            return x
        if isinstance(x, Rows):
            return x.map(lambda _, t: self._add_positions(t, offset))
        return x + sinusoidal_positions(x.shape[1], cfg.d_model, offset,
                                        device=x.device).to(cfg.dtype)[None]

    def _run_encoder(self, params, memory, ctx=None):
        """whisper's encoder over the stub frame embeddings ``[B, F, d]``:
        sinusoidal positions, the non-causal blocks (each under
        ``cfg.remat_policy``, with or without a mesh), then the encoder's
        final norm."""
        cfg = self.cfg

        def start(t):
            t = t.to(cfg.dtype)
            return t + sinusoidal_positions(t.shape[1], cfg.d_model,
                                            device=t.device).to(cfg.dtype)[None]

        x = ctx.split_rows(memory).map(lambda _, t: start(t)) \
            if self._mesh(ctx) else start(memory)

        def blk(h, p):
            return block_apply(p["sub0"], cfg, h, None, causal=False,
                               ctx=ctx)[0]

        blk = remat(blk, cfg.remat_policy)
        for l in range(cfg.encoder_layers):
            x = blk(x, layer_view(params["encoder"]["blocks"], l))
        return _norm(params["encoder"]["ln_f"], cfg, x, ctx)

    def _cross_kv_from_memory(self, params, enc_out, ctx=None):
        """Each decoder layer's cross K/V of the encoder's output, once a
        request: ``{"k", "v" [n_units, B, F, Hk, Dh]}`` bfloat16 (placed by
        the cache rules under a mesh, each block from its row's
        column-parallel pieces)."""
        cfg = self.cfg
        ks, vs = [], []
        for l in range(self._n_units()):
            p = layer_view(params["blocks"], l)["sub0"]["cross"]
            if self._mesh(ctx):
                from repro_torch.nn.attention import _placed_from_rows

                F_ = next(iter(enc_out.values())).shape[1]
                shape = (enc_out.batch, F_, cfg.padded_kv_heads,
                         cfg.resolved_head_dim)
                axes = ("batch", None, "kv_heads", None)
                for name, acc in (("wk", ks), ("wv", vs)):
                    pieces = {row: column_parallel(ctx, row, p[name], x,
                                                  cfg.dtype)
                              for row, x in enc_out.items()}
                    acc.append(_placed_from_rows(ctx, pieces, axes, shape,
                                                 torch.bfloat16))
                continue
            ks.append(dense(p["wk"], enc_out, cfg.dtype).to(torch.bfloat16))
            vs.append(dense(p["wv"], enc_out, cfg.dtype).to(torch.bfloat16))
        if self._mesh(ctx):
            return {"k": Placed.stack(ks), "v": Placed.stack(vs)}
        return {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _cross(self, params, batch, ctx=None):
        """whisper's cross K/V of ``batch["memory"]`` (None for a
        decoder-only config)."""
        if not self.cfg.encoder_layers:
            return None
        return self._cross_kv_from_memory(
            params, self._run_encoder(params, batch["memory"], ctx), ctx)

    def _head_weight(self, params):
        """The head's weight and whether it is the tied embedding."""
        if self.cfg.tie_embeddings:
            return params["embed"]["embedding"], True
        return params["lm_head"]["kernel"], False

    def _logits(self, params, x, ctx=None):
        """The head; under a mesh vocab-parallel (each shard's columns,
        joined on the row's first device)."""
        cfg = self.cfg
        if not self._mesh(ctx):
            if cfg.tie_embeddings:
                return x @ params["embed"]["embedding"].to(cfg.dtype).T
            return dense(params["lm_head"], x, cfg.dtype)

        if cfg.tie_embeddings:
            return vocab_logits(ctx, params["embed"]["embedding"], x,
                                cfg.dtype, tied=True)
        return vocab_logits(ctx, params["lm_head"]["kernel"], x, cfg.dtype,
                            tied=False)

    def _unit(self, p, x, positions, cache_u=None, cache_pos=None,
              xkv=None, ctx=None):
        """One unit's blocks in order: ``(x, {sub: cache}, aux summed over
        the unit)``; ``xkv`` the unit's cross ``(k, v)``."""
        new_cache = {}
        dev = ctx.device(ctx.rows()[0]) if self._mesh(ctx) else x.device
        aux = {"load_balance": torch.zeros((), device=dev),
               "router_z": torch.zeros((), device=dev)}
        for i in range(self._unit_size()):
            sub = f"sub{i}"
            cache_in = None
            if cache_u is not None:
                cache_in = dict(cache_u[sub], pos=cache_pos)
            x, nc, a = block_apply(p[sub], self.cfg, x, positions,
                                   cache=cache_in, cross_kv=xkv, ctx=ctx)
            new_cache[sub] = nc
            for n, v in a.items():
                aux[n] = aux[n] + v
        return x, new_cache, aux

    def _run_blocks(self, params, x, positions, caches=None, cache_pos=None,
                    cross_kv=None, ctx=None):
        """The units in order.  Returns ``(x, caches, aux)``: with
        ``caches`` (stacked decode KV) each unit's step against its view of
        them, else each unit's full-sequence K/V, both stacked ``[n_units,
        ...]``; ``aux`` the router losses summed over the units.
        ``cross_kv`` (stacked ``{"k", "v"}``) feeds each unit's
        cross-attention.  Under a mesh a decode step writes each unit's
        new K/V into its views of the placed ``caches`` in place and
        returns ``caches`` itself (the reference's step donates its
        cache): no new cache is stacked."""
        kv = {f"sub{i}": ([], []) for i in range(self._unit_size())}
        aux = None
        for l in range(self._n_units()):
            cache_u = None if caches is None else layer_view(caches, l)
            x, nc, a = self._unit(layer_view(params["blocks"], l), x,
                                  positions, cache_u, cache_pos,
                                  _cross_at(cross_kv, l), ctx)
            aux = a if aux is None else {n: aux[n] + a[n] for n in aux}
            for sub, (ks, vs) in kv.items():
                ks.append(nc[sub]["k"])
                vs.append(nc[sub]["v"])
        if self._mesh(ctx):
            if caches is not None:
                return x, caches, aux
            return x, {sub: {"k": Placed.stack(ks), "v": Placed.stack(vs)}
                       for sub, (ks, vs) in kv.items()}, aux
        return x, {sub: {"k": torch.stack(ks), "v": torch.stack(vs)}
                   for sub, (ks, vs) in kv.items()}, aux

    def _inputs(self, params, batch, ctx=None):
        """The full sequence's embeddings (image first, positions added),
        its positions ``[B, S_full]`` and whisper's cross K/V."""
        x = self._embed(params, batch["tokens"], batch.get("img_embeds"),
                        ctx)
        if self._mesh(ctx):
            positions = x.map(lambda _, t: torch.arange(
                t.shape[1], device=t.device)[None].expand(t.shape[0],
                                                          t.shape[1]))
        else:
            B, S_full = x.shape[:2]
            positions = torch.arange(S_full, device=x.device)[None] \
                .expand(B, S_full)
        return self._add_positions(x), positions, \
            self._cross(params, batch, ctx)

    def loss(self, params, batch, *, ctx=None):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``; whisper's ``memory``, llava's
        ``img_embeds``): ``(ce + 1e-4 * z [+ the MoE aux losses], {"ce",
        "z", "load_balance", "router_z"})``; an MoE config adds ``1e-2 *
        load_balance / n_units + 1e-3 * router_z / n_units``.  An image
        config's loss is over the text positions only, so its ``tokens``
        must not be empty.  Each unit runs under ``cfg.remat_policy``, with
        or without a mesh; the values do not depend on it.  Under a mesh
        (placed parameters) the blocks run their per-shard bodies, the
        rows keep their batch blocks through the vocab-parallel head and
        the chunked cross-entropy (:func:`mesh_ce_loss`)."""
        cfg = self.cfg
        S = batch["tokens"].shape[1]
        if cfg.n_img_tokens and S == 0:
            raise ValueError(
                "tokens must be longer than 0 after the image tokens: the "
                "loss of an image config is over the text positions only")
        x, positions, cross = self._inputs(params, batch, ctx)

        def blk(x, p, *xkv):
            x, _, a = self._unit(p, x, positions, xkv=xkv or None, ctx=ctx)
            return x, a["load_balance"], a["router_z"]

        blk = remat(blk, cfg.remat_policy)
        dev = ctx.device(ctx.rows()[0]) if self._mesh(ctx) else x.device
        lb = rz = torch.zeros((), device=dev)
        for l in range(self._n_units()):
            xkv = _cross_at(cross, l) or ()
            x, a_lb, a_rz = blk(x, layer_view(params["blocks"], l), *xkv)
            lb, rz = lb + a_lb, rz + a_rz
        x = _norm(params["ln_f"], cfg, x, ctx)
        if cfg.n_img_tokens:  # the image positions carry no loss
            x = x.map(lambda _, t: t[:, -S:]) if self._mesh(ctx) \
                else x[:, -S:]
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        if self._mesh(ctx):
            ce, z = mesh_ce_loss(ctx, *self._head_weight(params), cfg.dtype,
                                 x, labels, mask.float(), cfg.loss_chunk)
        else:
            ce, z = chunked_ce_loss(
                lambda xc: self._logits(params, xc), x,
                labels.to(x.device), mask.float().to(x.device),
                cfg.loss_chunk)
        loss = ce + 1e-4 * z
        if cfg.moe:
            loss = loss + 1e-2 * lb / self._n_units() \
                + 1e-3 * rz / self._n_units()
        return loss, {"ce": ce, "z": z, "load_balance": lb, "router_z": rz}

    def prefill(self, params, batch, *, ctx=None):
        """Full-sequence forward over ``batch["tokens"] [B, S]`` (after
        llava's ``img_embeds``; with whisper's ``memory``): the last
        position's logits ``[B, Vp]`` and the decode-ready cache (``pos``
        = the full sequence's length, ``S_full``; whisper's adds
        ``cross_kv``).  Its K/V hold ``S_full`` slots: a sliding-window
        config that decodes on from it writes slot ``pos % S_full``, over
        the first token, as the reference's does; to keep the whole
        window, copy them into a cache of ``min(max_len, window)``
        slots.  Under a mesh the cache comes back placed by the cache
        rules and the logits whole on the mesh's first device."""
        cfg = self.cfg
        x, positions, cross = self._inputs(params, batch, ctx)
        x, layer_caches, _ = self._run_blocks(params, x, positions,
                                              cross_kv=cross, ctx=ctx)
        x = _norm(params["ln_f"], cfg, x, ctx)
        if self._mesh(ctx):
            S_full = next(iter(x.values())).shape[1]
            logits = ctx.join_rows(self._logits(
                params, x.map(lambda _, t: t[:, -1:]), ctx))[:, 0]
        else:
            S_full = x.shape[1]
            logits = self._logits(params, x[:, -1:])[:, 0]
        cache = {"layers": layer_caches, "pos": S_full}
        if cross is not None:
            cache["cross_kv"] = cross
        return logits, cache

    def decode_step(self, params, cache, tokens: torch.Tensor, *, ctx=None):
        """tokens ``[B, 1]``; cache ``{"layers", "pos"}`` (and whisper's
        ``cross_kv``) -> ``(logits [B, Vp], new cache)`` with ``pos + 1``
        (new K/V tensors; the given cache is not changed).  Under a mesh
        the parameters and cache are placed, the new K/V rows are written
        into the given cache's blocks in place (the returned cache holds
        the same ``layers``), and the logits come back whole on the mesh's
        first device."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(cache["pos"])
        if self._mesh(ctx):
            x = self._add_positions(self._embed(params, tokens, ctx=ctx),
                                    pos)
            positions = x.map(lambda _, t: torch.full(
                (t.shape[0], 1), pos, dtype=torch.int64, device=t.device))
        else:
            x = self._add_positions(embed(params["embed"], tokens,
                                          cfg.dtype), pos)
            positions = torch.full((B, 1), pos, dtype=torch.int64,
                                   device=x.device)
        x, new_layers, _ = self._run_blocks(params, x, positions,
                                            caches=cache["layers"],
                                            cache_pos=pos,
                                            cross_kv=cache.get("cross_kv"),
                                            ctx=ctx)
        x = _norm(params["ln_f"], cfg, x, ctx)
        if self._mesh(ctx):
            logits = ctx.join_rows(self._logits(params, x, ctx))[:, -1]
        else:
            logits = self._logits(params, x)[:, -1]
        return logits, dict(cache, layers=new_layers, pos=pos + 1)
