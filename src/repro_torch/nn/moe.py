"""Mixture-of-Experts on one device (port of ``repro.nn.moe``'s local
schedule).

Routing, dispatch, the expert FFNs and the combine are plain tensor math, as
the reference computes them outside any kernel.  Dispatch is scatter-based
with all shapes static: each expert takes at most ``cap = ceil(t * k *
capacity_factor / n_experts)`` entries, and an entry's slot is the count
of earlier entries routed to the same expert in the flat ``[t * k]``
token-major order (the exclusive cumulative sum over the one-hot routing
matrix).  Entries past the capacity are dropped, as the reference drops
them.  Padded experts get ``-1e30`` router logits, so they never win.

The combine adds each token's ``k`` weighted expert outputs in the compute
dtype in a fixed order (``j = 0 .. k-1``, rounding after every addition),
the order of the reference's ``y.at[flat_tok].add(contrib)``: no atomics,
so a step gives the same bits every time.

The reference's expert-parallel schedules (sequence-sharded all-to-all and
the replicated psum) need a mesh; the port has none yet (ROADMAP Queue 1
#7), and :func:`moe_apply` raises when given one.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import dense
from .module import ParamSpec

__all__ = ["moe_spec", "moe_apply", "moe_capacity", "dropped_entries"]


def moe_spec(cfg, dtype=torch.float32):
    m = cfg.moe
    E, d, f = m.padded_experts, cfg.d_model, m.d_ff_expert
    return {
        "router": {"kernel": ParamSpec((d, E), dtype, "fan_in")},
        "w_gate": ParamSpec((E, d, f), dtype, "fan_in"),
        "w_up": ParamSpec((E, d, f), dtype, "fan_in"),
        "w_down": ParamSpec((E, f, d), dtype, "fan_in"),
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
    counts = torch.bincount(experts.reshape(-1),
                            minlength=m.padded_experts).float()
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
    onehot = F.one_hot(flat_e, E)                       # [t*k, E]
    pos = torch.cumsum(onehot, 0) - onehot              # exclusive count
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    return flat_e, flat_pos, flat_pos < cap


def _moe_body(params, cfg, x_local: torch.Tensor):
    """x ``[t, d]`` -> ``(y [t, d], aux)`` on one device (the reference's
    ``model_axis=None`` branch)."""
    m = cfg.moe
    cd = cfg.dtype
    E = m.padded_experts
    t, d = x_local.shape
    k = m.top_k
    probs, experts, aux = _route(params, cfg, x_local, cd)
    cap = moe_capacity(cfg, t)
    flat_e, flat_pos, keep = _dispatch(cfg, experts, cap)
    flat_tok = torch.arange(t, device=x_local.device).repeat_interleave(k)
    flat_p = probs.reshape(-1)

    # the reference sends dropped entries out of bounds; here they land in
    # a spare slot ``cap`` that is cut off (every kept (expert, slot) pair
    # is distinct, and no index is read back to the host)
    send = torch.zeros((E, cap + 1, d), dtype=cd, device=x_local.device)
    send = send.index_put((flat_e, torch.where(keep, flat_pos, cap)),
                          x_local.to(cd)[flat_tok])[:, :cap]
    out = _expert_ffn(send, params["w_gate"], params["w_up"],
                      params["w_down"], cd)
    gathered = out[torch.where(keep, flat_e, 0),
                   torch.where(keep, flat_pos, 0)]          # [t*k, d]
    contrib = torch.where(keep[:, None], gathered * flat_p[:, None],
                          torch.zeros((), dtype=cd, device=x_local.device))
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):  # the reference's scatter-add order, in cd
        y = y + contrib[:, j]
    return y, aux


def moe_apply(params, cfg, x: torch.Tensor, *,
              mesh=None) -> Tuple[torch.Tensor, Dict]:
    """x ``[B, S, d]`` -> ``(y [B, S, d], aux)``: every token of the batch
    routed together (the reference's single-device schedule)."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE schedules are not ported yet (ROADMAP "
            "Queue 1: expert parallelism)")
    B, S, d = x.shape
    y, aux = _moe_body(params, cfg, x.reshape(-1, d))
    return y.reshape(B, S, d), aux


def dropped_entries(cfg, experts: torch.Tensor, t: int) -> int:
    """Routing entries over capacity among ``experts [t, k]``."""
    _, _, keep = _dispatch(cfg, experts, moe_capacity(cfg, t))
    return int((~keep).sum())
