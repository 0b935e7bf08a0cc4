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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn.attention import attention, attention_spec, init_cache_specs
from repro_torch.nn.layers import (dense, embed, embed_spec, rmsnorm,
                                   rmsnorm_spec)
from repro_torch.nn.module import ParamSpec, layer_view, remat, stack_specs
from repro_torch.nn.ssm import (mamba_block, mamba_decode, mamba_spec,
                                ssm_cache_specs)
from .transformer import chunked_ce_loss, mlp, mlp_spec

__all__ = ["HybridLM"]


def _no_mesh(ctx):
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(
            "the hybrid family does not run under a mesh yet (ROADMAP "
            "Queue 1: the hybrid family under a mesh)")


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

    def _shared_attn(self, params_i, x, x0, positions, cache=None):
        """One shared-block application on ``concat(x, x0)``: ``(x,
        cache)``."""
        cfg = self.cfg
        xin = torch.cat([x, x0], -1)
        h, new_cache = attention(params_i["attn"], cfg,
                                 rmsnorm(params_i["ln"], xin, cfg.norm_eps),
                                 positions, causal=True, cache=cache)
        x = x + h
        x = x + mlp(params_i["mlp"], cfg,
                    rmsnorm(params_i["ln_mlp"], x, cfg.norm_eps))
        return x, new_cache

    def _select_shared(self, params, app: int):
        return layer_view(params["shared"], app % self.cfg.n_shared_attn_blocks)

    def _logits(self, params, x):
        return dense(params["lm_head"], x, self.cfg.dtype)

    # -- modes ---------------------------------------------------------------

    def loss(self, params, batch, *, ctx=None):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``): ``(ce + 1e-4 * z, {"ce", "z"})``.  Every
        shared application and every Mamba block runs under
        ``cfg.remat_policy``; the values do not depend on it."""
        _no_mesh(ctx)
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        x0 = x
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

        def shared_fn(p, x, x0):
            return self._shared_attn(p, x, x0, positions)[0]

        def blk(h, p):
            return h + mamba_block(p["mixer"], cfg,
                                   rmsnorm(p["ln"], h, cfg.norm_eps))

        shared_fn = remat(shared_fn, cfg.remat_policy)
        blk = remat(blk, cfg.remat_policy)
        for app, (start, length) in enumerate(self._segments()):
            x = shared_fn(self._select_shared(params, app), x, x0)
            for l in range(start, start + length):
                x = blk(x, layer_view(params["blocks"], l))
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        ce, z = chunked_ce_loss(lambda xc: self._logits(params, xc), x,
                                labels, mask.float(), cfg.loss_chunk)
        return ce + 1e-4 * z, {"ce": ce, "z": z}

    def prefill(self, params, batch, *, ctx=None):
        """Full-sequence pass over ``batch["tokens"] [B, S]``: the last
        position's logits ``[B, Vp]`` and the decode-ready cache (each
        application's K/V, each layer's SSM state, ``pos`` = S)."""
        _no_mesh(ctx)
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.dtype)
        x0 = x
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        ks, vs, convs, ssds = [], [], [], []
        for app, (start, length) in enumerate(self._segments()):
            x, kv = self._shared_attn(self._select_shared(params, app), x,
                                      x0, positions)
            ks.append(kv["k"])
            vs.append(kv["v"])
            for l in range(start, start + length):
                p = layer_view(params["blocks"], l)
                y, st = mamba_block(p["mixer"], cfg,
                                    rmsnorm(p["ln"], x, cfg.norm_eps),
                                    return_state=True)
                x = x + y
                convs.append(st["conv"])
                ssds.append(st["ssd"])
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._logits(params, x[:, -1:])[:, 0]
        return logits, {"ssm": {"layers": {"conv": torch.stack(convs),
                                           "ssd": torch.stack(ssds)}},
                        "attn": {"k": torch.stack(ks), "v": torch.stack(vs)},
                        "pos": S}

    def decode_step(self, params, cache, tokens: torch.Tensor, *, ctx=None):
        """tokens ``[B, 1]``; cache ``{"ssm", "attn", "pos"}`` -> ``(logits
        [B, Vp], new cache)`` with ``pos + 1``."""
        _no_mesh(ctx)
        cfg = self.cfg
        pos = int(cache["pos"])
        B = tokens.shape[0]
        x = embed(params["embed"], tokens, cfg.dtype)
        x0 = x
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
        states = cache["ssm"]["layers"]
        ks, vs, convs, ssds = [], [], [], []
        for app, (start, length) in enumerate(self._segments()):
            kv = {"k": cache["attn"]["k"][app], "v": cache["attn"]["v"][app],
                  "pos": pos}
            x, nc = self._shared_attn(self._select_shared(params, app), x,
                                      x0, positions, cache=kv)
            ks.append(nc["k"])
            vs.append(nc["v"])
            for l in range(start, start + length):
                p = layer_view(params["blocks"], l)
                st = {"conv": states["conv"][l], "ssd": states["ssd"][l]}
                y, st2 = mamba_decode(p["mixer"], cfg,
                                      rmsnorm(p["ln"], x, cfg.norm_eps), st)
                x = x + y
                convs.append(st2["conv"].to(states["conv"].dtype))
                ssds.append(st2["ssd"].to(states["ssd"].dtype))
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = self._logits(params, x)[:, -1]
        return logits, dict(cache,
                            ssm={"layers": {"conv": torch.stack(convs),
                                            "ssd": torch.stack(ssds)}},
                            attn={"k": torch.stack(ks), "v": torch.stack(vs)},
                            pos=pos + 1)
