"""Grouped-query attention (port of ``repro.nn.attention``).

One implementation covers MHA/GQA (the KV heads repeated, interleaved, to
the query heads), QKV bias, qk-norm, the sliding window (a rolling KV
buffer at decode), cross-attention (whisper's decoder: the queries of
``x`` against given bfloat16 K/V, no rope, no mask) and padded head counts
(padding lives in the config).

Two numerics, as the reference's: the dense path (small ``S*T``: decode,
short prompts, and any non-causal full-sequence pass such as whisper's
encoder) attends in float32; the chunked path (``S*T >= 2048**2`` for a
causal full-sequence pass or a cross-attention, long prompts) keeps
bfloat16 operands with float32 accumulation, casts
the probabilities to bfloat16 before the attend, and walks query blocks so
that no ``[B, H, S, T]`` score tensor is materialized.  Both are plain
tensor math: the reference computes attention with einsums outside any
kernel.  Masked scores are ``NEG_INF``, not ``-inf``.

The KV cache is bfloat16 whatever ``cfg.dtype`` is.  A decode write at a
position past the cache's end lands in its last slot, as the reference's
clamped ``dynamic_update_slice`` puts it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .layers import dense, dense_spec, rmsnorm, rmsnorm_spec, rope
from .module import ParamSpec

__all__ = ["attention_spec", "attention", "init_cache_specs", "NEG_INF"]

NEG_INF = -1e30
#: past this many score elements per head, a causal full-sequence pass or
#: a cross-attention takes the chunked path
_CHUNK_THRESHOLD = 2048 * 2048
_Q_CHUNK = 1024
#: the KV cache's dtype
CACHE_DTYPE = torch.bfloat16


def attention_spec(cfg, d_in: Optional[int] = None, dtype=torch.float32):
    d = d_in or cfg.d_model
    Hp, Hk, Dh = cfg.padded_heads, cfg.padded_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_spec(d, (Hp, Dh), bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_spec(d, (Hk, Dh), bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_spec(d, (Hk, Dh), bias=cfg.qkv_bias, dtype=dtype),
        "wo": {"kernel": ParamSpec((Hp, Dh, cfg.d_model), dtype, "fan_in")},
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_spec(Dh, dtype)
        p["k_norm"] = rmsnorm_spec(Dh, dtype)
    return p


def _project_qkv(params, cfg, x, positions):
    """``x [B, S, d]`` -> q ``[B, S, Hp, Dh]``, k, v ``[B, S, Hk, Dh]``
    in ``cfg.dtype``; qk-norm before rope."""
    q = dense(params["wq"], x, cfg.dtype)
    k = dense(params["wk"], x, cfg.dtype)
    v = dense(params["wv"], x, cfg.dtype)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.pos_embed == "rope" and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(q, k, v):
    """GQA: each KV head repeated ``Hp // Hk`` times in place (head ``h``
    of the result is KV head ``h // rep``)."""
    Hp, Hk = q.shape[-2], k.shape[-2]
    if Hk != Hp:
        rep = Hp // Hk
        k = torch.repeat_interleave(k, rep, dim=-2)
        v = torch.repeat_interleave(v, rep, dim=-2)
    return k, v


def _sdpa_dense(cfg, q, k, v, mask) -> torch.Tensor:
    """Materialized scores in float32: q ``[B, S, H, Dh]``, k, v
    ``[B, T, H, Dh]``, mask ``[B, 1, S, T]`` bool or None."""
    Dh = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (Dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(cfg.dtype)


def _sdpa_chunked(cfg, q, k, v, q_pos, kv_pos, causal: bool):
    """Query blocks of ``_Q_CHUNK`` (halved until they divide S), one
    ``[B, H, blk, T]`` float32 score block at a time.  The operands are
    ``cfg.dtype``; the products are summed in float32 (bfloat16 products
    are exact in float32, so the operands are widened to float32 for the
    contraction), the probabilities are cast to ``cfg.dtype`` before the
    attend, and each block's output is cast to ``cfg.dtype``."""
    B, S, Hp, Dh = q.shape
    blk = _Q_CHUNK
    while S % blk:
        blk //= 2
    kf = k.to(cfg.dtype).float()
    vf = v.to(cfg.dtype).float()
    qd = q.to(cfg.dtype)
    out = []
    for i in range(0, S, blk):
        qb, qpb = qd[:, i:i + blk].float(), q_pos[:, i:i + blk]
        s = torch.einsum("bshd,bthd->bhst", qb, kf) * (Dh ** -0.5)
        if causal:
            m = kv_pos[:, None, :] <= qpb[:, :, None]
            if cfg.window:
                m &= kv_pos[:, None, :] > qpb[:, :, None] - cfg.window
            s = torch.where(m[:, None], s, NEG_INF)
        p = torch.softmax(s, -1).to(cfg.dtype)
        ob = torch.einsum("bhst,bthd->bshd", p.float(), vf)
        out.append(ob.to(cfg.dtype))
    return torch.cat(out, 1)


def _causal_mask(q_pos, kv_pos, window: int):
    """q_pos ``[B, S]``, kv_pos ``[B, T]`` -> ``[B, 1, S, T]`` bool."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        m &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    return m[:, None]


def attention(params, cfg, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, cache: Optional[Dict] = None,
              cross_kv=None) -> Tuple[torch.Tensor, Dict]:
    """Returns ``(out [B, S, d], cache)``.

    Full-sequence when ``cache is None`` (the returned cache holds this
    pass's K/V in bfloat16); otherwise one decode step against ``cache``
    ``{"k", "v" [B, T, Hk, Dh], "pos"}`` (``pos`` the host int of the next
    write position), returning the written ``{"k", "v"}`` (new tensors; the
    given ones are not changed).  ``cross_kv=(k, v)`` (``[B, T, Hk, Dh]``)
    attends the queries of ``x`` to them instead, unmasked, and returns
    ``cache`` as given."""
    B, S, _ = x.shape
    if cross_kv is not None:
        q = dense(params["wq"], x, cfg.dtype)
        if cfg.qk_norm:
            q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        kr, vr = _repeat_kv(q, cross_kv[0], cross_kv[1])
        T = kr.shape[1]
        if S * T >= _CHUNK_THRESHOLD:
            zeros = torch.zeros((B, T), dtype=torch.int64, device=x.device)
            out = _sdpa_chunked(cfg, q, kr, vr, positions, zeros,
                                causal=False)
        else:
            out = _sdpa_dense(cfg, q, kr, vr, None)
    elif cache is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
        kr, vr = _repeat_kv(q, k, v)
        if causal and S * S >= _CHUNK_THRESHOLD:
            out = _sdpa_chunked(cfg, q, kr, vr, positions, positions,
                                causal=True)
        else:
            mask = (_causal_mask(positions, positions, cfg.window)
                    if causal else None)
            out = _sdpa_dense(cfg, q, kr, vr, mask)
        cache = {"k": k.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}
    else:
        q, k_new, v_new = _project_qkv(params, cfg, x, positions)
        T = cache["k"].shape[1]
        idx = int(cache["pos"])
        # the reference's dynamic_update_slice clamps a start past the end
        slot = idx % T if cfg.window else min(idx, T - S)
        k = cache["k"].clone()
        v = cache["v"].clone()
        k[:, slot:slot + S] = k_new.to(k.dtype)
        v[:, slot:slot + S] = v_new.to(v.dtype)
        cache = {"k": k, "v": v}
        kv_pos = torch.arange(T, device=x.device)[None]
        if cfg.window:
            # rolling buffer: every slot holds a token of the window once
            # idx >= T; before that, the unwritten slots are masked
            mask = (kv_pos <= idx)[:, None, None, :].expand(B, 1, S, T)
        else:
            mask = _causal_mask(positions, kv_pos.expand(B, T), 0)
        kr, vr = _repeat_kv(q, k, v)
        out = _sdpa_dense(cfg, q, kr, vr, mask)
    y = torch.einsum("bshd,hde->bse", out.to(cfg.dtype),
                     params["wo"]["kernel"].to(cfg.dtype))
    return y, cache


def init_cache_specs(cfg, batch: int, max_len: int, n_layers: int,
                     layer_axis: bool = True):
    """Spec tree of a decode KV cache: ``{"k", "v"}`` of
    ``[n_layers, batch, T, Hk, Dh]`` bfloat16 zeros (without the layer axis
    when ``layer_axis`` is False); ``T`` is ``max_len``, or the window when
    it is shorter."""
    Hk, Dh = cfg.padded_kv_heads, cfg.resolved_head_dim
    T = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, T, Hk, Dh)
    if layer_axis:
        shape = (n_layers, *shape)
    return {"k": ParamSpec(shape, CACHE_DTYPE, "zeros"),
            "v": ParamSpec(shape, CACHE_DTYPE, "zeros")}
