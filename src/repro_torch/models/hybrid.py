"""Zamba2-style hybrid: a Mamba2 backbone with shared attention blocks
(port of ``repro.models.hybrid``).

A stack of Mamba2 blocks; before every segment of ``shared_attn_period``
blocks a shared transformer block runs on ``concat(hidden, embedding)``
(``2 * d`` wide into the attention, ``d`` out), its parameters taken
round-robin from ``n_shared_attn_blocks`` sets (application ``a`` uses set
``a % n_shared_attn_blocks``).  The blocks and the shared sets are stored
stacked, as the reference scans them, and walked with Python loops over
layer views.

The decode cache is ``{"ssm": {"layers": {"conv", "ssd" [L, ...]}}, "attn":
{"k", "v" [n_applications, B, T, Hk, Dh]}, "pos"}``: a KV cache for each
application, bfloat16, and ``pos`` (the next write position) a host int
after a prefill or a step.  A step writes every layer's new SSM state into
its place and returns new tensors; the given cache is not changed.

Under a ``ctx`` with a mesh (parameters and cache placed by
``nn.module.shardings``) the three modes run the per-shard bodies the
other families use: a vocab-parallel embedding and head, the shared
attention column-parallel over its heads on the ``2 * d``-wide input (a
replicated KV head selected per shard, ``wo`` row-parallel, the cache
time-sharded where the rules say), the MLP and the Mamba blocks; the
activations are ``nn.layers.Rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn.attention import attention, attention_spec, init_cache_specs
from repro_torch.nn.layers import (Rows, dense, embed, embed_spec, rmsnorm,
                                   rmsnorm_spec, vocab_embed, vocab_logits)
from repro_torch.nn.module import (ParamSpec, Placed, layer_view, remat,
                                   stack_specs)
from repro_torch.nn.ssm import (mamba_block, mamba_decode, mamba_spec,
                                ssm_cache_specs)
from .mamba import _ce
from .transformer import _add, _norm, mlp, mlp_spec

__all__ = ["HybridLM"]


def _mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


@dataclasses.dataclass
class HybridLM:
    cfg: Any

    # -- structure ---------------------------------------------------------

    def _segments(self):
        """``[(start, length), ...]`` covering the layers in period-sized
        chunks."""
        cfg = self.cfg
        period = cfg.shared_attn_period
        segs, i = [], 0
        while i < cfg.n_layers:
            segs.append((i, min(period, cfg.n_layers - i)))
            i += period
        return segs

    def n_attn_applications(self) -> int:
        return len(self._segments())

    def _shared_block_spec(self):
        cfg = self.cfg
        return {"ln": rmsnorm_spec(2 * cfg.d_model, cfg.param_dtype),
                "attn": attention_spec(cfg, d_in=2 * cfg.d_model,
                                       dtype=cfg.param_dtype),
                "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
                "mlp": mlp_spec(cfg, cfg.param_dtype)}

    def param_specs(self):
        cfg = self.cfg
        block = {"ln": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
                 "mixer": mamba_spec(cfg, cfg.param_dtype)}
        return {
            "embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                cfg.param_dtype),
            "blocks": stack_specs(block, cfg.n_layers),
            "shared": stack_specs(self._shared_block_spec(),
                                  cfg.n_shared_attn_blocks),
            "ln_f": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
            "lm_head": {"kernel": ParamSpec((cfg.d_model, cfg.padded_vocab),
                                            cfg.param_dtype, "fan_in",
                                            axes=("embed", "vocab"))},
        }

    def cache_specs(self, batch: int, max_len: int):
        """The decode cache's specs; ``pos`` materializes as a 0-d tensor,
        which a caller may replace by a host int."""
        cfg = self.cfg
        return {"ssm": {"layers": ssm_cache_specs(cfg, batch, cfg.n_layers)},
                "attn": init_cache_specs(cfg, batch, max_len,
                                         self.n_attn_applications(),
                                         layer_axis=True),
                "pos": ParamSpec((), torch.int32, "zeros", axes=())}

    # -- the shared attention application -----------------------------------

    def _shared_attn(self, params_i, x, x0, positions, cache=None, ctx=None):
        """One shared-block application on ``concat(x, x0)``: ``(x,
        cache)`` (under a mesh each row's blocks, the attention and the MLP
        their per-shard bodies)."""
        cfg = self.cfg
        if _mesh(ctx):
            xin = x.map(lambda row, t: torch.cat([t, x0[row]], -1))
        else:
            xin = torch.cat([x, x0], -1)
        h, new_cache = attention(params_i["attn"], cfg,
                                 _norm(params_i["ln"], cfg, xin, ctx),
                                 positions, causal=True, cache=cache, ctx=ctx)
        x = _add(x, h)
        x = _add(x, mlp(params_i["mlp"], cfg,
                        _norm(params_i["ln_mlp"], cfg, x, ctx), ctx=ctx))
        return x, new_cache

    def _select_shared(self, params, app: int):
        return layer_view(params["shared"], app % self.cfg.n_shared_attn_blocks)

    def _logits(self, params, x):
        return dense(params["lm_head"], x, self.cfg.dtype)

    def _head(self, params, x, ctx) -> torch.Tensor:
        """The head's logits; under a mesh vocab-parallel over the rows,
        joined on the mesh's first device."""
        if not _mesh(ctx):
            return self._logits(params, x)
        return ctx.join_rows(vocab_logits(ctx, params["lm_head"]["kernel"],
                                          x, self.cfg.dtype, tied=False))

    def _inputs(self, params, tokens, positions_at, ctx):
        """The embeddings (vocab-parallel rows under a mesh) and their
        positions, ``positions_at(B, S, device)`` of each block."""
        cfg = self.cfg
        if not _mesh(ctx):
            x = embed(params["embed"], tokens, cfg.dtype)
            return x, positions_at(*tokens.shape, x.device)
        x = vocab_embed(ctx, params["embed"]["embedding"],
                        ctx.split_rows(tokens), cfg.dtype)
        return x, x.map(lambda _, t: positions_at(t.shape[0], t.shape[1],
                                                  t.device))

    # -- modes ---------------------------------------------------------------

    def loss(self, params, batch, *, ctx=None):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``): ``(ce + 1e-4 * z, {"ce", "z"})``.  Every
        shared application and every Mamba block runs under
        ``cfg.remat_policy``; the values do not depend on it.  Under a mesh
        (placed parameters) they run their per-shard bodies, the rows'
        final states are joined on the mesh's first device and the head is
        vocab-parallel there."""
        cfg = self.cfg
        x, positions = self._inputs(params, batch["tokens"], _arange, ctx)
        x0 = x

        def shared_fn(p, x, x0):
            return self._shared_attn(p, x, x0, positions, ctx=ctx)[0]

        def blk(h, p):
            return _add(h, mamba_block(p["mixer"], cfg,
                                       _norm(p["ln"], cfg, h, ctx), ctx=ctx))

        shared_fn = remat(shared_fn, cfg.remat_policy)
        blk = remat(blk, cfg.remat_policy)
        for app, (start, length) in enumerate(self._segments()):
            x = shared_fn(self._select_shared(params, app), x, x0)
            for l in range(start, start + length):
                x = blk(x, layer_view(params["blocks"], l))
        x = _norm(params["ln_f"], cfg, x, ctx)
        return _ce(self, params, x, batch, ctx)

    def prefill(self, params, batch, *, ctx=None):
        """Full-sequence pass over ``batch["tokens"] [B, S]``: the last
        position's logits ``[B, Vp]`` and the decode-ready cache (each
        application's K/V, each layer's SSM state, ``pos`` = S).  Under a
        mesh the cache comes back placed by the cache rules and the logits
        whole on the mesh's first device."""
        cfg = self.cfg
        S = batch["tokens"].shape[1]
        stack = Placed.stack if _mesh(ctx) else torch.stack
        x, positions = self._inputs(params, batch["tokens"], _arange, ctx)
        x0 = x
        ks, vs, convs, ssds = [], [], [], []
        for app, (start, length) in enumerate(self._segments()):
            x, kv = self._shared_attn(self._select_shared(params, app), x,
                                      x0, positions, ctx=ctx)
            ks.append(kv["k"])
            vs.append(kv["v"])
            for l in range(start, start + length):
                p = layer_view(params["blocks"], l)
                y, st = mamba_block(p["mixer"], cfg,
                                    _norm(p["ln"], cfg, x, ctx),
                                    return_state=True, ctx=ctx)
                x = _add(x, y)
                convs.append(st["conv"])
                ssds.append(st["ssd"])
        x = _norm(params["ln_f"], cfg, x, ctx)
        last = x.map(lambda _, t: t[:, -1:]) if _mesh(ctx) else x[:, -1:]
        logits = self._head(params, last, ctx)[:, 0]
        return logits, {"ssm": {"layers": {"conv": stack(convs),
                                           "ssd": stack(ssds)}},
                        "attn": {"k": stack(ks), "v": stack(vs)},
                        "pos": S}

    def decode_step(self, params, cache, tokens: torch.Tensor, *, ctx=None):
        """tokens ``[B, 1]``; cache ``{"ssm", "attn", "pos"}`` -> ``(logits
        [B, Vp], new cache)`` with ``pos + 1``.  Under a mesh the parameters
        and cache are placed and the logits come back whole on the mesh's
        first device."""
        cfg = self.cfg
        pos = int(cache["pos"])
        stack = Placed.stack if _mesh(ctx) else torch.stack
        x, positions = self._inputs(
            params, tokens, lambda b, s, dev: torch.full(
                (b, s), pos, dtype=torch.int64, device=dev), ctx)
        x0 = x
        states = cache["ssm"]["layers"]
        ks, vs, convs, ssds = [], [], [], []
        for app, (start, length) in enumerate(self._segments()):
            kv = {"k": layer_view(cache["attn"]["k"], app),
                  "v": layer_view(cache["attn"]["v"], app), "pos": pos}
            x, nc = self._shared_attn(self._select_shared(params, app), x,
                                      x0, positions, cache=kv, ctx=ctx)
            ks.append(nc["k"])
            vs.append(nc["v"])
            for l in range(start, start + length):
                p = layer_view(params["blocks"], l)
                st = {"conv": layer_view(states["conv"], l),
                      "ssd": layer_view(states["ssd"], l)}
                y, st2 = mamba_decode(p["mixer"], cfg,
                                      _norm(p["ln"], cfg, x, ctx), st,
                                      ctx=ctx)
                x = _add(x, y)
                convs.append(st2["conv"])
                ssds.append(st2["ssd"])
        x = _norm(params["ln_f"], cfg, x, ctx)
        logits = self._head(params, x, ctx)[:, -1]
        return logits, dict(cache,
                            ssm={"layers": {"conv": stack(convs),
                                            "ssd": stack(ssds)}},
                            attn={"k": stack(ks), "v": stack(vs)},
                            pos=pos + 1)


def _arange(b: int, s: int, device) -> torch.Tensor:
    """Positions ``0 .. s - 1`` of a ``[b, s]`` block."""
    return torch.arange(s, device=device)[None].expand(b, s)
