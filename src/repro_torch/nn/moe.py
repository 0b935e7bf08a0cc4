"""Mixture-of-Experts (port of ``repro.nn.moe``): the single-device
schedule and the two expert-parallel schedules on a mesh.

Routing, dispatch, the expert FFNs and the combine are plain tensor math, as
the reference computes them outside any kernel.  Dispatch is scatter-based
with all shapes static: each expert takes at most ``cap = ceil(t * k *
capacity_factor / n_experts)`` entries of the ``t`` tokens routed
together, and an entry's slot is the count of earlier entries routed to
the same expert in the flat ``[t * k]`` token-major order (the exclusive
cumulative sum over the one-hot routing matrix).  Entries past the
capacity are dropped, as the reference drops them.  Padded experts get
``-1e30`` router logits, so they never win.

The combine adds each token's ``k`` weighted expert outputs in the compute
dtype in a fixed order (``j = 0 .. k-1``, rounding after every addition),
the order of the reference's ``y.at[flat_tok].add(contrib)``: no atomics,
so a step gives the same bits every time.

Under a ``nn.layers.Ctx`` with a mesh the input is ``nn.layers.Rows``
(each mesh row's batch block on the row's first device) and the experts
are cut over ``"model"`` (``E_loc = E / tp`` a shard) and over the data
axes on ``embed`` (FSDP: a shard's block is cast to ``cfg.dtype`` on its
device, then joined, as the reference moves bfloat16).  The reference's
schedule choice (``S % tp == 0 and S >= tp``):

* **all-to-all** (a prefill, a training step, ``tp = 1`` on a data-only
  mesh): each row's sequence is cut into ``tp`` pieces, one a model
  shard's device; each shard routes its own ``t_local`` tokens with its
  own capacity ``moe_capacity(cfg, t_local)`` and builds its ``send [E,
  cap, d]``; shard ``i`` receives ``send_j[i E_loc:(i+1) E_loc]`` of every
  source ``j``, joined on the capacity axis in source order (the tiled
  ``all_to_all``), runs its experts, and the results go back the same
  way; each shard combines its tokens and the row's sequence is joined on
  its first device;
* **psum** (a decode step, ``S = 1``): every shard routes all the row's
  tokens, runs its slice of the experts into its own slice of ``ret``
  (zeros elsewhere) and combines; the partial outputs are added in
  float32 in shard order on the row's first device and cast once (the
  port's rule for every reduction: the reference's ``psum`` adds them in
  ``cfg.dtype``, so in bfloat16 the two may round apart).

Each shard's ``load_balance`` and ``router_z`` come from its own routing
and are averaged over every shard in mesh order (the reference's
``pmean`` over ``(*data_axes, "model")``): this is not the unsharded
layer's aux, whose routing sees all the tokens at once.  For the same
reason the all-to-all schedule drops per shard, at its own capacity, so
at the published ``capacity_factor`` it differs from the unsharded layer
wherever an expert overflows.  :func:`recording_routes` records each
shard's routing, and :func:`dropped_entries` counts its drops.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from . import coords
from .layers import Rows, dense
from .module import ParamSpec

__all__ = ["moe_spec", "moe_apply", "moe_capacity", "dropped_entries",
           "recording_routes"]


def moe_spec(cfg, dtype=torch.float32):
    m = cfg.moe
    E, d, f = m.padded_experts, cfg.d_model, m.d_ff_expert
    return {
        "router": {"kernel": ParamSpec((d, E), dtype, "fan_in",
                                       axes=(None, None))},
        "w_gate": ParamSpec((E, d, f), dtype, "fan_in",
                            axes=("expert", "embed", None)),
        "w_up": ParamSpec((E, d, f), dtype, "fan_in",
                          axes=("expert", "embed", None)),
        "w_down": ParamSpec((E, f, d), dtype, "fan_in",
                            axes=("expert", None, "embed")),
    }


def moe_capacity(cfg, t: int) -> int:
    """Entries an expert takes from ``t`` tokens."""
    m = cfg.moe
    return max(1, int(math.ceil(t * m.top_k * m.capacity_factor
                                / m.n_experts)))


def _route(params, cfg, x_tokens: torch.Tensor, compute_dtype):
    """x ``[t, d]`` -> ``(probs [t, k] in compute_dtype, experts [t, k],
    aux losses)``: the top-k of the float32 router softmax, renormalized,
    with the Switch load-balance loss and the router z-loss."""
    m = cfg.moe
    logits = dense(params["router"], x_tokens, torch.float32)  # [t, E_pad]
    if m.padded_experts > m.n_experts:  # dead padding experts never win
        live = torch.arange(m.padded_experts, device=logits.device) \
            < m.n_experts
        logits = torch.where(live, logits, -1e30)
    probs_full = torch.softmax(logits, -1)
    probs, experts = torch.topk(probs_full, m.top_k, dim=-1)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    t = x_tokens.shape[0]
    flat = experts.reshape(-1)  # a static-shape bincount
    counts = torch.zeros(m.padded_experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    dispatch_frac = counts / (t * m.top_k)
    prob_frac = probs_full.mean(0)
    aux = {"load_balance": m.n_experts * torch.sum(dispatch_frac * prob_frac),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}
    return probs.to(compute_dtype), experts, aux


def _expert_ffn(recv, w_gate, w_up, w_down, compute_dtype):
    """recv ``[E, c, d]`` through each expert's gated-SiLU FFN."""
    g = torch.einsum("ecd,edf->ecf", recv, w_gate.to(compute_dtype))
    u = torch.einsum("ecd,edf->ecf", recv, w_up.to(compute_dtype))
    h = F.silu(g) * u
    return torch.einsum("ecf,efd->ecd", h, w_down.to(compute_dtype))


def _dispatch(cfg, experts: torch.Tensor, cap: int):
    """``(flat_e, flat_pos, keep)`` of the ``[t * k]`` routing entries in
    token-major order: each entry's expert, its slot (the entries before it
    routed to the same expert) and whether the slot is under ``cap``."""
    E = cfg.moe.padded_experts
    flat_e = experts.reshape(-1)
    # [t*k, E]: one_hot's comparison, without its host read of the ids
    onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)) \
        .long()
    pos = torch.cumsum(onehot, 0) - onehot              # exclusive count
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    return flat_e, flat_pos, flat_pos < cap


def _dispatch_local(params, cfg, x_local: torch.Tensor):
    """Route ``t`` local tokens ``[t, d]`` and scatter them into ``send [E,
    cap, d]`` (cap from ``t``).  Returns ``(send, plan, aux, experts)``;
    ``plan`` is what :func:`_combine` reads back."""
    cd = cfg.dtype
    E, k = cfg.moe.padded_experts, cfg.moe.top_k
    t, d = x_local.shape
    probs, experts, aux = _route(params, cfg, x_local, cd)
    cap = moe_capacity(cfg, t)
    flat_e, flat_pos, keep = _dispatch(cfg, experts, cap)
    flat_tok = torch.arange(t, device=x_local.device).repeat_interleave(k)
    # the reference sends dropped entries out of bounds; here they land in
    # a spare slot ``cap`` that is cut off (every kept (expert, slot) pair
    # is distinct, and no index is read back to the host)
    send = torch.zeros((E, cap + 1, d), dtype=cd, device=x_local.device)
    send = send.index_put((flat_e, torch.where(keep, flat_pos, cap)),
                          x_local.to(cd)[flat_tok])[:, :cap]
    return send, (flat_e, flat_pos, keep, probs.reshape(-1)), aux, experts


def _combine(cfg, ret: torch.Tensor, plan) -> torch.Tensor:
    """``ret [E, cap, d]`` back to the tokens ``[t, d]``: each token's
    ``k`` weighted outputs added in ``cfg.dtype`` in the order ``j = 0 ..
    k-1``, a dropped entry adding 0."""
    cd, k = cfg.dtype, cfg.moe.top_k
    flat_e, flat_pos, keep, flat_p = plan
    gathered = ret[torch.where(keep, flat_e, 0),
                   torch.where(keep, flat_pos, 0)]          # [t*k, d]
    contrib = torch.where(keep[:, None], gathered * flat_p[:, None],
                          torch.zeros((), dtype=cd, device=ret.device))
    contrib = contrib.reshape(-1, k, ret.shape[-1])
    y = contrib[:, 0]
    for j in range(1, k):  # the reference's scatter-add order, in cd
        y = y + contrib[:, j]
    return y


#: the open :func:`recording_routes` lists
_ROUTE_LOGS: List[list] = []


@contextlib.contextmanager
def recording_routes():
    """Within the block every :func:`moe_apply` call appends ``{shard:
    experts [t, k]}`` (detached) to the yielded list: ``shard`` is the mesh
    coordinate of the model shard that routed ``experts`` (None without a
    mesh).  A forward under remat routes again in the backward pass, so
    record a forward without autograd."""
    log: list = []
    _ROUTE_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTE_LOGS.remove(log)


def _record(routes: Dict):
    for log in _ROUTE_LOGS:
        log.append({s: e.detach() for s, e in routes.items()})


def moe_apply(params, cfg, x, *, ctx=None) -> Tuple[torch.Tensor, Dict]:
    """x ``[B, S, d]`` -> ``(y [B, S, d], aux)``.  Without a mesh every
    token of the batch routes together (the reference's single-device
    schedule); under a ``ctx`` with a mesh ``x`` and ``y`` are
    ``nn.layers.Rows`` and the layer runs the all-to-all schedule when
    ``S % tp == 0 and S >= tp``, else the psum schedule (see the module
    docstring), the aux losses averaged over the shards."""
    if ctx is not None and ctx.mesh is not None:
        return _moe_mesh(params, cfg, ctx, x)
    B, S, d = x.shape
    send, plan, aux, experts = _dispatch_local(params, cfg, x.reshape(-1, d))
    _record({None: experts})
    out = _expert_ffn(send, params["w_gate"], params["w_up"],
                      params["w_down"], cfg.dtype)
    return _combine(cfg, out, plan).reshape(B, S, d), aux


def _shard_experts(ctx, params, cfg, row, j: int, E_loc: int):
    """Shard ``j``'s ``[w_gate, w_up, w_down]`` of ``row`` on its device:
    its ``E_loc`` experts, each block cast to ``cfg.dtype`` on its own
    device before the FSDP join over the data axes."""
    out = []
    for name in ("w_gate", "w_up", "w_down"):
        w = params[name]
        t = ctx.weight(w, row, j, cfg.dtype)
        if ctx.splits(w, 0) == 1:  # the expert dim replicates: a slice
            t = t.narrow(0, j * E_loc, E_loc)
        out.append(t)
    return out


def _moe_mesh(params, cfg, ctx, xs: Rows):
    """The expert-parallel schedules over each mesh row (module
    docstring).  Returns ``(Rows y, aux)``, the aux on the mesh's first
    device."""
    tp = ctx.tp
    E = cfg.moe.padded_experts
    if E % tp:
        raise ValueError(f"{E} experts do not divide over {tp} model "
                         f"shards; pad them (MoEConfig.pad_experts_to)")
    E_loc = E // tp
    cd = cfg.dtype
    router = params["router"]["kernel"]
    auxes, routes = {}, {}

    def row_out(row, x):
        b, S, d = x.shape
        ws = [_shard_experts(ctx, params, cfg, row, j, E_loc)
              for j in ctx.shards(row, tp)]

        def dispatch(j, tokens):
            local = {"router": {"kernel": ctx.weight(router, row, j)}}
            send, plan, aux, experts = _dispatch_local(local, cfg, tokens)
            auxes[ctx.coord(row, j)] = aux
            routes[ctx.coord(row, j)] = experts
            return send, plan

        if S % tp == 0 and S >= tp:  # all-to-all over the sequence pieces
            pieces = ctx.split_seq(row, x)
            sent = [dispatch(j, pieces[j].reshape(-1, d))
                    for j in ctx.shards(row, tp)]
            cap = sent[0][0].shape[1]
            outs = []
            with coords.kind("all-to-all"):
                for i in ctx.shards(row, tp):
                    dev = ctx.device(row, i)
                    recv = torch.cat([send[i * E_loc:(i + 1) * E_loc].to(dev)
                                      for send, _ in sent], 1)
                    outs.append(_expert_ffn(recv, *ws[i], cd))
                ys = []
                for j in ctx.shards(row, tp):
                    dev = ctx.device(row, j)
                    ret = torch.cat([o[:, j * cap:(j + 1) * cap].to(dev)
                                     for o in outs], 0)
                    ys.append(_combine(cfg, ret, sent[j][1])
                              .reshape(b, S // tp, d))
            return ctx.join_seq(row, ys)
        parts = []  # psum: every shard routes every token of the row
        for j in ctx.shards(row, tp):
            send, plan = dispatch(j, x.reshape(-1, d).to(ctx.device(row, j)))
            out = _expert_ffn(send[j * E_loc:(j + 1) * E_loc], *ws[j], cd)
            pad = [torch.zeros((n, *out.shape[1:]), dtype=out.dtype,
                               device=out.device)
                   for n in (j * E_loc, (tp - j - 1) * E_loc)]
            parts.append(_combine(cfg, torch.cat([pad[0], out, pad[1]], 0),
                                  plan))
        return ctx.reduce(parts, row, cd).reshape(b, S, d)

    ys = xs.map(row_out)
    _record(routes)
    dev = ctx.device(ctx.rows()[0])
    order = [c for c in ctx.mesh.coords if c in auxes]
    aux = {}
    with ctx.at(ctx.rows()[0]), coords.kind("all-reduce"):
        for n in ("load_balance", "router_z"):  # pmean, in mesh order
            acc = auxes[order[0]][n].to(dev, torch.float32)
            for c in order[1:]:
                acc = acc + auxes[c][n].to(dev, torch.float32)
            aux[n] = acc / len(order)
    return ys, aux


def dropped_entries(cfg, experts, t=None):
    """Routing entries over capacity among ``experts [t, k]`` (``t``
    defaults to its rows).  Given a mapping ``{shard: experts}`` (one
    entry of :func:`recording_routes`), the count of each shard at its own
    capacity: ``{shard: n}``."""
    if isinstance(experts, Mapping):
        return {s: dropped_entries(cfg, e) for s, e in experts.items()}
    t = experts.shape[0] if t is None else t
    _, _, keep = _dispatch(cfg, experts, moe_capacity(cfg, t))
    return int((~keep).sum())
