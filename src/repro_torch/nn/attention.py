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

from . import coords
from .layers import (Rows, assemble, column_parallel, dense, dense_spec,
                     rmsnorm, rmsnorm_spec, rope, row_parallel_rows)
from .module import ParamSpec, Placed, TablePlacement

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
        "wq": dense_spec(d, (Hp, Dh), axes=("embed", "heads", None),
                         bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_spec(d, (Hk, Dh), axes=("embed", "kv_heads", None),
                         bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_spec(d, (Hk, Dh), axes=("embed", "kv_heads", None),
                         bias=cfg.qkv_bias, dtype=dtype),
        "wo": {"kernel": ParamSpec((Hp, Dh, cfg.d_model), dtype, "fan_in",
                                   axes=("heads", None, "embed"))},
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
              cross_kv=None, *, ctx=None) -> Tuple[torch.Tensor, Dict]:
    """Returns ``(out [B, S, d], cache)``.

    Full-sequence when ``cache is None`` (the returned cache holds this
    pass's K/V in bfloat16); otherwise one decode step against ``cache``
    ``{"k", "v" [B, T, Hk, Dh], "pos"}`` (``pos`` the host int of the next
    write position), returning the written ``{"k", "v"}`` (new tensors; the
    given ones are not changed).  ``cross_kv=(k, v)`` (``[B, T, Hk, Dh]``)
    attends the queries of ``x`` to them instead, unmasked, and returns
    ``cache`` as given.

    Under a ``ctx`` with a mesh, ``x`` and ``positions`` are
    ``nn.layers.Rows`` and the parameters, ``cache`` and ``cross_kv`` are
    placed (``nn.module.Placed``): q/k/v are column-parallel over the
    shards' heads, each shard attends over its heads (a replicated KV
    head selected per shard) and its KV blocks (a time-sharded cache's
    blocks merged by log-sum-exp in time order), ``wo`` is row-parallel;
    the cache comes back placed (a prefill's by the cache rules)."""
    if ctx is not None and ctx.mesh is not None:
        return _attention_mesh(params, cfg, ctx, x, positions, causal, cache,
                               cross_kv)
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
    axes = ("batch", "cache_seq", "kv_heads", None)
    if layer_axis:
        shape = (n_layers, *shape)
        axes = ("layers", *axes)
    return {"k": ParamSpec(shape, CACHE_DTYPE, "zeros", axes=axes),
            "v": ParamSpec(shape, CACHE_DTYPE, "zeros", axes=axes)}


# ----------------------------------------------------------------------------
# Under a mesh: per-shard bodies (``nn.layers.Ctx``)
# ----------------------------------------------------------------------------


def _time_blocks(kv, b_lo: int, b_hi: int, h_lo: int, h_hi: int, dev):
    """The blocks of a placed ``[B, T, Hk, Dh]`` K or V that hold batch
    rows ``[b_lo, b_hi)`` and KV heads ``[h_lo, h_hi)``, one a time block,
    in time order: ``[(t0, t1, block narrowed to those rows and heads)]``
    (a block on ``dev`` preferred, and under a tracker one held at the
    current scope, ``nn.coords``)."""
    found = {}
    cur = coords.current()
    for c, t in kv.unique():
        (b0, b1), (t0, t1), (k0, k1), _ = kv.ranges(c)
        if not (b0 <= b_lo and b_hi <= b1 and k0 <= h_lo and h_hi <= k1):
            continue
        blk = t.narrow(0, b_lo - b0, b_hi - b_lo) \
            .narrow(2, h_lo - k0, h_hi - h_lo)
        held = coords.coords_of(t)
        if t0 not in found or (t.device == dev and (
                held is None or cur is None or cur <= held)):
            found[t0] = (t0, t1, blk)
    return [found[t0] for t0 in sorted(found)]


def _heads_of(j: int, n: int, Hp: int, rep: int):
    """Shard ``j``'s query heads ``[q0, q1)`` of ``n``, the KV heads
    ``[k0, k1)`` they read, and each query head's index among those."""
    size = Hp // n
    q0, q1 = j * size, (j + 1) * size
    k0, k1 = q0 // rep, (q1 - 1) // rep + 1
    idx = [(q0 + i) // rep - k0 for i in range(size)]
    return q0, q1, k0, k1, idx


def _select(t, idx, dev):
    """The KV heads ``idx`` of ``t [B, T, h, Dh]`` on ``dev`` (the GQA
    repeat of a shard's heads)."""
    t = t.to(dev)
    return t.index_select(2, torch.tensor(idx, device=dev))


def _partial_softmax(q, k, v, mask):
    """One time block's share of the attention, in float32: the running
    max ``m [B, H, S, 1]``, the sum ``l`` of ``exp(s - m)`` and the
    unnormalised output ``o [B, S, H, Dh]``."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e.sum(-1, keepdim=True), torch.einsum("bhst,bthd->bshd", e,
                                                    v.float())


def _merge_partials(parts, dev, dtype):
    """The time blocks' shares merged by log-sum-exp, in block order, on
    ``dev``."""
    parts = [tuple(t.to(dev) for t in p) for p in parts]
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = o = None
    for pm, pl, po in parts:
        w = torch.exp(pm - m)                       # [B, H, S, 1]
        wl = pl * w
        wo = po * w.squeeze(-1).transpose(1, 2)[..., None]
        l = wl if l is None else l + wl
        o = wo if o is None else o + wo
    return (o / l.squeeze(-1).transpose(1, 2)[..., None]).to(dtype)


def _attend_blocks(cfg, q, blocks_k, blocks_v, idx, dev, mask_fn):
    """Shard-local attention of ``q [B, S, h, Dh]`` (on ``dev``) over the
    time blocks of its KV: one block attends as the unsharded dense path
    does; several give partial softmaxes merged in time order."""
    if len(blocks_k) == 1:
        t0, t1, k = blocks_k[0]
        v = blocks_v[0][2]
        return _sdpa_dense(cfg, q, _select(k, idx, dev), _select(v, idx, dev),
                           mask_fn(t0, t1))
    parts = []
    for (t0, t1, k), (_, _, v) in zip(blocks_k, blocks_v):
        bdev = k.device
        mask = mask_fn(t0, t1)
        with coords.near(k):  # each block's share where the block is
            parts.append(_partial_softmax(q.to(bdev), _select(k, idx, bdev),
                                          _select(v, idx, bdev),
                                          mask.to(bdev)))
    with coords.kind("all-reduce"):
        return _merge_partials(parts, dev, cfg.dtype)


def _project_mesh(params, cfg, ctx, row, x, positions, qkv: bool = True):
    """Column-parallel q (and k, v) pieces of one row, qk-norm then rope
    (rope where ``positions`` is given)."""
    def finish(pieces, name):
        out = []
        for _, (r, t) in zip(ctx.shards(row, len(pieces)), pieces):
            if cfg.qk_norm:
                t = rmsnorm({"scale": params[name]["scale"].local(
                    ctx.coord(row, 0)).to(t.device)}, t, cfg.norm_eps)
            if cfg.pos_embed == "rope" and positions is not None:
                t = rope(t, positions.to(t.device), cfg.rope_theta)
            out.append((r, t))
        return out

    q = finish(column_parallel(ctx, row, params["wq"], x, cfg.dtype),
               "q_norm")
    if not qkv:
        return q
    k = finish(column_parallel(ctx, row, params["wk"], x, cfg.dtype),
               "k_norm")
    return q, k, column_parallel(ctx, row, params["wv"], x, cfg.dtype)


def _write_cache(ctx, kv, pieces_by_row, slot: int, S: int):
    """A new placed K or V: each block holding positions ``[slot, slot +
    S)`` is copied with the new rows written (assembled from the row's
    column-parallel pieces on the block's device); the other blocks are
    kept as they are."""
    new = {}
    for c, t in kv.each():
        (b0, b1), (t0, t1), (k0, k1), _ = kv.ranges(c)
        s0, s1 = max(slot, t0), min(slot + S, t1)
        if s0 >= s1:
            new[id(t)] = t
            continue
        row = ctx.coord(c, 0)
        r0, r1 = ctx.batch_block(row, kv.shape[0])
        kn = assemble(pieces_by_row[row], k0, k1, t.device, 2)
        kn = kn.narrow(0, b0 - r0, b1 - b0)
        blk = t.clone()
        blk[:, s0 - t0:s1 - t0] = kn[:, s0 - slot:s1 - slot].to(t.dtype)
        new[id(t)] = blk
    return Placed(kv.placement, kv.shape, kv.dtype,
                  {c: new[id(t)] for c, t in kv.blocks.items()})


def _placed_from_rows(ctx, pieces_by_row, axes, shape, dtype):
    """A placed activation-made leaf (a prefill's K/V, whisper's cross
    K/V) of logical ``axes``, each block assembled from its row's
    column-parallel pieces (head dim 2) and narrowed to its batch and
    time block."""
    placement = TablePlacement(ctx.mesh, ctx.pspec(axes, shape))
    rows = {}
    for row in ctx.rows():
        rows.setdefault(ctx.batch_block(row, shape[0]), row)

    def block(index, dev):
        (b0, b1), (t0, t1), (k0, k1), _ = placement.block_ranges(shape,
                                                                 index)
        (r0, r1), row = next(((r, w) for r, w in rows.items()
                              if r[0] <= b0 and b1 <= r[1]))
        t = assemble(pieces_by_row[row], k0, k1, dev, 2)
        return t.narrow(0, b0 - r0, b1 - b0).narrow(1, t0, t1 - t0) \
            .to(dtype).contiguous()

    return Placed.build(placement, shape, dtype, block)


def _attention_mesh(params, cfg, ctx, xs, positions, causal, cache,
                    cross_kv):
    """:func:`attention` under a mesh: ``xs`` (a ``nn.layers.Rows``) and
    ``positions`` map each row to its batch block (on the row's first
    device); returns the rows' outputs and the cache (placed)."""
    Hp, Hk, Dh = cfg.padded_heads, cfg.padded_kv_heads, \
        cfg.resolved_head_dim
    rep = Hp // Hk
    wq, wo = params["wq"]["kernel"], params["wo"]["kernel"]
    nq = ctx.splits(wq, 1)
    if ctx.splits(wo, 0) != nq:
        raise ValueError("wq and wo cut their heads differently")
    B = xs.batch
    outs = {}
    new_cache = cache
    kv_rows = {}
    q_rows = {}
    for row, x in xs.items():
        if cross_kv is not None:
            q_rows[row] = _project_mesh(params, cfg, ctx, row, x, None,
                                        qkv=False)
        else:
            q_rows[row], kp, vp = _project_mesh(
                params, cfg, ctx, row, x,
                None if positions is None else positions[row])
            kv_rows[row] = (kp, vp)
    S = next(iter(xs.values())).shape[1]
    if cross_kv is None and cache is not None:
        T = cache["k"].shape[1]
        idx = int(cache["pos"])
        slot = idx % T if cfg.window else min(idx, T - S)
        new_cache = {
            "k": _write_cache(ctx, cache["k"],
                              {r: kv[0] for r, kv in kv_rows.items()},
                              slot, S),
            "v": _write_cache(ctx, cache["v"],
                              {r: kv[1] for r, kv in kv_rows.items()},
                              slot, S)}
    for row, x in xs.items():
        b0, b1 = ctx.batch_block(row, B)
        pos = None if positions is None else positions[row]
        pieces = []
        for j, ((q0, q1), q) in zip(ctx.shards(row, len(q_rows[row])),
                                    q_rows[row]):
            dev = q.device
            _, _, k0, k1, idx_h = _heads_of(j, nq, Hp, rep)
            if cross_kv is not None:
                bk = _time_blocks(cross_kv[0], b0, b1, k0, k1, dev)
                bv = _time_blocks(cross_kv[1], b0, b1, k0, k1, dev)
                k, v = _select(bk[0][2], idx_h, dev), \
                    _select(bv[0][2], idx_h, dev)
                T = k.shape[1]
                if S * T >= _CHUNK_THRESHOLD:
                    zeros = torch.zeros((b1 - b0, T), dtype=torch.int64,
                                        device=dev)
                    out = _sdpa_chunked(cfg, q, k, v, pos.to(dev), zeros,
                                        causal=False)
                else:
                    out = _sdpa_dense(cfg, q, k, v, None)
            elif cache is None:
                kp, vp = kv_rows[row]
                k = _select(assemble(kp, k0, k1, dev, 2), idx_h, dev)
                v = _select(assemble(vp, k0, k1, dev, 2), idx_h, dev)
                p = None if pos is None else pos.to(dev)
                if causal and S * S >= _CHUNK_THRESHOLD:
                    out = _sdpa_chunked(cfg, q, k, v, p, p, causal=True)
                else:
                    mask = _causal_mask(p, p, cfg.window) if causal else None
                    out = _sdpa_dense(cfg, q, k, v, mask)
            else:
                bk = _time_blocks(new_cache["k"], b0, b1, k0, k1, dev)
                bv = _time_blocks(new_cache["v"], b0, b1, k0, k1, dev)
                idx = int(cache["pos"])

                def mask_fn(t0, t1, p=pos.to(dev)):
                    kv_pos = torch.arange(t0, t1, device=dev)[None]
                    if cfg.window:
                        return (kv_pos <= idx)[:, None, None, :].expand(
                            p.shape[0], 1, S, t1 - t0)
                    return _causal_mask(p, kv_pos.expand(p.shape[0],
                                                         t1 - t0), 0)

                out = _attend_blocks(cfg, q, bk, bv, idx_h, dev, mask_fn)
            pieces.append(((q0, q1), out))
        outs[row] = pieces
    if cross_kv is None and cache is None:
        shape = (B, S, Hk, Dh)
        axes = ("batch", "cache_seq", "kv_heads", None)
        new_cache = {
            "k": _placed_from_rows(ctx, {r: kv[0] for r, kv in
                                         kv_rows.items()}, axes, shape,
                                   CACHE_DTYPE),
            "v": _placed_from_rows(ctx, {r: kv[1] for r, kv in
                                         kv_rows.items()}, axes, shape,
                                   CACHE_DTYPE)}
    ys = _wo_mesh(cfg, ctx, wo, outs, B)
    return ys, new_cache


def _wo_mesh(cfg, ctx, wo, outs, B: int):
    """The row-parallel output projection: each shard's heads against its
    ``wo`` block (through ``row_parallel`` under ``ctx.explicit_rs``, the
    same sums); ``B`` the global batch."""
    _, S, _, Dh = next(iter(outs.values()))[0][1].shape
    ys = row_parallel_rows(ctx, outs, wo, "bshd,hde->bse",
                           (B, S, wo.shape[0], Dh), cfg.dtype)
    if ys is not None:
        return ys
    ys = {}
    for row, pieces in outs.items():
        parts = [torch.einsum("bshd,hde->bse", t.to(cfg.dtype).float(),
                              ctx.weight(wo, row, j).to(cfg.dtype).float())
                 for j, (_, t) in zip(ctx.shards(row, len(pieces)), pieces)]
        ys[row] = ctx.reduce(parts, row, cfg.dtype)
    return ys
