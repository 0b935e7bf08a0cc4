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

Placed trees (``nn.module.Placed`` leaves, a mesh's): :func:`adamw_init`
gives each moment the placement of its parameter (each block on its
block's device), :func:`adamw_init_specs` the specs a caller places the
state by (ZeRO-1 renames the moments' axes), and :func:`adamw_update`
runs each leaf block by block on its moment's placement (a gradient or
parameter placed otherwise is re-cut to it, the new parameter back to its
own).  The global norm sums each distinct block once, in block order; an
int8 moment's row scale is the max over the blocks of its row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.nn import coords
from repro_torch.nn.module import ParamSpec, Placed, TablePlacement

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_specs", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]


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


def _scale_placement(p: Placed) -> TablePlacement:
    """An int8 moment's row scales ``[..., 1]``: cut as ``p`` but on the
    last dim."""
    return TablePlacement(p.mesh, (*p.spec[:-1], None))


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments of each parameter's shape (and placement)."""
    def zeros(p):
        if not isinstance(p, Placed):
            return _zeros_moment(p, cfg.quantize_moments)
        if not cfg.quantize_moments:
            return p.map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                               device=t.device))
        shape = (*p.shape[:-1], 1)
        return {"q": p.map(lambda t: torch.zeros(t.shape, dtype=torch.int8,
                                                 device=t.device)),
                "scale": Placed.build(
                    _scale_placement(p), shape, torch.float32,
                    lambda i, dev: torch.zeros(
                        [b - a for a, b in _scale_placement(p).block_ranges(
                            shape, i)], dtype=torch.float32, device=dev))}

    dev = tree_leaves(params)[0].device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adamw_init_specs(param_specs, cfg: AdamWConfig, remap_axes=None):
    """The optimizer state's spec tree (what ``nn.module.shardings`` places
    it by): ``count`` and a moment per parameter spec, float32, or int8
    codes with float32 row scales ``[..., 1]`` (the last axis replicated).
    ``remap_axes`` renames the moments' logical axes only (ZeRO-1: the
    parameters keep ``"embed"`` replicated over the data axes while the
    moments take ``"opt_embed"``, sharded there)."""
    def axes(a):
        if not remap_axes:
            return tuple(a)
        return tuple(remap_axes.get(x, x) for x in a)

    def moment(s):
        if isinstance(s, dict):
            return {k: moment(v) for k, v in s.items()}
        if not cfg.quantize_moments:
            return ParamSpec(s.shape, torch.float32, "zeros",
                             axes=axes(s.axes))
        return {"q": ParamSpec(s.shape, torch.int8, "zeros",
                               axes=axes(s.axes)),
                "scale": ParamSpec((*s.shape[:-1], 1), torch.float32,
                                   "zeros", axes=(*axes(s.axes[:-1]), None))}

    return {"count": ParamSpec((), torch.int32, "zeros", axes=()),
            "m": moment(param_specs), "v": moment(param_specs)}


def _sq_sum(x, dev) -> torch.Tensor:
    """The float32 sum of squares of a leaf on ``dev`` (a placed leaf's
    distinct blocks once each, in block order: a replica never twice)."""
    if not isinstance(x, Placed):
        return torch.sum(torch.square(x.float())).to(dev)
    seen, total = set(), None
    for c, t in x.unique():
        i = x.placement.block_index(c)
        if i in seen:
            continue
        seen.add(i)
        part = torch.sum(torch.square(t.float())).to(dev)
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    with coords.kind("all-reduce"):
        sq = sum(_sq_sum(x, dev) for x in leaves)
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    """The tree scaled to a global norm of at most ``max_norm``, and the
    norm before scaling."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)

    def mul(x):
        if isinstance(x, Placed):
            return x.map(lambda t: t * scale.to(t.device, t.dtype))
        return x * scale.to(x.dtype)

    return tree_map(mul, tree), n


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
    grads = tree_map(lambda g: g.map(lambda t: t.float())
                     if isinstance(g, Placed) else g.float(), grads)
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

    def moments(p, g, m_f, v_f):
        """The float32 moments and the new parameter of one tensor (a whole
        leaf or one block), the step's scalars moved to its device."""
        dev = p.device
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        update = (m_f / bc1.to(dev)) / (torch.sqrt(v_f / bc2.to(dev))
                                        + cfg.eps)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr.to(dev) * update).to(p.dtype), m_f, v_f

    def leaf(p, g, m, v):
        if cfg.quantize_moments:
            m_f = _dq8(m["q"], m["scale"])
            v_f = _dq8(v["q"], v["scale"])
        else:
            m_f, v_f = m, v
        p_new, m_f, v_f = moments(p, g, m_f, v_f)
        if cfg.quantize_moments:
            mq, ms = _q8(m_f)
            vq, vs = _q8(v_f)
            return p_new, {"q": mq, "scale": ms}, {"q": vq, "scale": vs}
        return p_new, m_f, v_f

    def walk(p, g, m, v):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        if isinstance(p, Placed):
            return _placed_leaf(moments, p, g, m, v, cfg.quantize_moments)
        return leaf(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state["m"], state["v"])
    new_state = {"count": count, "m": new_m, "v": new_v}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


def _placed_leaf(moments, p: Placed, g, m, v, quantized: bool):
    """:func:`adamw_update` of one placed leaf, block by block on its
    moment's placement: ``g`` and ``p`` re-cut to it when placed otherwise
    (ZeRO-1), the new parameter re-cut back to ``p``'s placement.  An int8
    moment's row scale is the max over the blocks of its row (the last dim
    may be cut), so its codes are the whole leaf's."""
    mp = (m["q"] if quantized else m).placement
    pq, gq = p.replace(mp), g.replace(mp)
    if quantized:
        m_f = m["q"].map(_dq8, m["scale"])
        v_f = v["q"].map(_dq8, v["scale"])
    else:
        m_f, v_f = m, v
    trip = {}

    def step(pt, gt, mt, vt):
        r = moments(pt, gt, mt, vt)
        trip[id(pt)] = r
        return r[0]

    new_p = pq.map(step, gq, m_f, v_f)
    m_new = pq.map(lambda pt: trip[id(pt)][1])
    v_new = pq.map(lambda pt: trip[id(pt)][2])
    new_p = new_p.replace(p.placement)
    if not quantized:
        return new_p, m_new, v_new
    return new_p, _q8_placed(m_new, m["scale"].placement), \
        _q8_placed(v_new, v["scale"].placement)


def _q8_placed(x: Placed, scale_placement: TablePlacement):
    """:func:`_q8` of a placed float32 moment, ``{"q", "scale"}``: each
    row's scale from the max of ``|x|`` over the blocks that hold the row
    (exact: a max), placed by ``scale_placement``, the codes block by
    block."""
    amax, home = {}, {}
    for c, t in x.each():  # the rows' max, kept where a row's first is
        key = x.placement.block_index(c)[:-1]
        a = t.abs().amax(-1, keepdim=True)
        if key not in amax:
            amax[key], home[key] = a, coords.current()
            continue
        with coords.at(home[key]), coords.kind("all-reduce"):
            amax[key] = torch.maximum(amax[key], a.to(amax[key].device))
    scales = {}
    for k, a in amax.items():
        with coords.at(home[k]):
            scales[k] = (a / 127.0 + 1e-12).float()

    def codes(t, c):
        sc = scales[x.placement.block_index(c)[:-1]].to(t.device)
        return torch.clamp(torch.round(t / sc), -127, 127).to(torch.int8)

    made = {}
    for c, t in x.each():
        made[id(t)] = codes(t, c)
    q_blocks = {c: made[id(t)] for c, t in x.blocks.items()}
    q = Placed(x.placement, x.shape, torch.int8, q_blocks)
    scale = Placed.build(_scale_placement(x), (*x.shape[:-1], 1),
                         torch.float32,
                         lambda index, dev: scales[index[:-1]].to(dev))
    return {"q": q, "scale": scale.replace(scale_placement)}
