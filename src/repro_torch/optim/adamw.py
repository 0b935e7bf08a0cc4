"""AdamW with optional block-quantized (int8) moment storage (port of
``repro.optim.adamw``).

Functional, as the reference: the state is the tree ``{"count" int32 0-d,
"m", "v"}`` with ``m``/``v`` shaped like the parameters (float32, or with
``quantize_moments`` an int8 code tensor of the parameter's shape and
float32 per-row scales ``[..., 1]`` each), and :func:`adamw_update` returns
new tensors, leaving its arguments as they were.  ``torch.optim.AdamW`` is
not used: its decay, clipping and moment storage are not the reference's.

The int8 codec divides by the row scale (a true division, never a
reciprocal multiply) and rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from repro_torch.interop import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_moments: bool = False  # int8 + per-row scales


# ---- shape-preserving int8 codec -------------------------------------------


def _q8(x: torch.Tensor):
    scale = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


# ---- state -----------------------------------------------------------------


def _zeros_moment(p: torch.Tensor, quantized: bool):
    if not quantized:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "scale": torch.zeros((*p.shape[:-1], 1), dtype=torch.float32,
                                 device=p.device)}


def adamw_init(params, cfg: AdamWConfig):
    def zeros(p):
        return _zeros_moment(p, cfg.quantize_moments)

    dev = tree_leaves(params)[0].device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    """The tree scaled to a global norm of at most ``max_norm``, and the
    norm before scaling."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``; ``lr(step)`` takes a tensor step."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One step.  Returns ``(new_params, new_state, {"grad_norm", "lr"})``;
    no decay on parameters of fewer than 2 dimensions (norms, biases)."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    lr = (cfg.lr(count) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32, device=count.device))
    bc1 = 1 - b1 ** count.float()
    bc2 = 1 - b2 ** count.float()

    def leaf(p, g, m, v):
        if cfg.quantize_moments:
            m_f = _dq8(m["q"], m["scale"])
            v_f = _dq8(v["q"], v["scale"])
        else:
            m_f, v_f = m, v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        update = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * update).to(p.dtype)
        if cfg.quantize_moments:
            mq, ms = _q8(m_f)
            vq, vs = _q8(v_f)
            return p_new, {"q": mq, "scale": ms}, {"q": vq, "scale": vs}
        return p_new, m_f, v_f

    def walk(p, g, m, v):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        return leaf(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state["m"], state["v"])
    new_state = {"count": count, "m": new_m, "v": new_v}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
