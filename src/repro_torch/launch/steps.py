"""Step-function factories (port of ``repro.launch.steps``): train, prefill
and decode for any ported config.

The prefill and decode steps close over the model and a sharding context
(:func:`make_ctx`; an MoE config's prefill takes ``nn.moe``'s all-to-all
schedule, its decode the psum one): with a mesh (``launch.mesh.Mesh``)
they take placed
parameters and caches (``nn.module.place(tree, shardings(specs, mesh))``)
and run the layers' per-shard bodies; ``rule_overrides`` edits the rule
table (``{"cache_seq": "model"}`` shards the KV cache's time axis).  The
train step takes the same placed parameters (and an optimizer state from
``adamw_init`` of them, or placed by ``adamw_init_specs``).
"""

from __future__ import annotations

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models import build_model
from repro_torch.nn import coords
from repro_torch.nn.layers import Ctx
from repro_torch.nn.module import DEFAULT_RULES, Placed, ShardingRules
from repro_torch.optim import AdamWConfig, adamw_update

__all__ = ["make_ctx", "make_train_step", "make_prefill_step",
           "make_decode_step", "active_matmul_params"]


def make_ctx(mesh, rule_overrides=None, decode=False,
             explicit_rs=False) -> Ctx:
    """The sharding context of ``mesh`` (None: one device) under
    :data:`~repro_torch.nn.module.DEFAULT_RULES` updated by
    ``rule_overrides``."""
    if mesh is None:
        return Ctx(decode=decode)
    rules = dict(DEFAULT_RULES)
    if rule_overrides:
        rules.update(rule_overrides)
    return Ctx(mesh=mesh, rules=ShardingRules.for_mesh(mesh, rules),
               decode=decode, explicit_rs=explicit_rs)


def _cast_tree_bf16(p):
    """float32 leaves of 2 or more dimensions cast to bfloat16 (the master
    weights as the step computes with them); a differentiable cast, block
    by block for a placed leaf."""
    def cast(a):
        if a.dtype != torch.float32 or a.dim() < 2:
            return a
        if isinstance(a, Placed):
            return a.map(lambda t: t.to(torch.bfloat16))
        return a.to(torch.bfloat16)

    return tree_map(cast, p)


def _fresh(a):
    """A leaf detached and requiring grad (each distinct block of a placed
    one: the sharing kept)."""
    if isinstance(a, Placed):
        return a.map(lambda t: t.detach().requires_grad_())
    return a.detach().requires_grad_()


def _distinct(leaf) -> list:
    """The tensors autograd differentiates for one leaf: the leaf, or a
    placed leaf's distinct blocks."""
    if isinstance(leaf, Placed):
        return [t for _, t in leaf.unique()]
    return [leaf]


def _with_grads(leaf, grads: dict):
    """``leaf``'s gradient: a tensor, or a placed leaf whose blocks are
    its blocks' gradients (zeros where a block took no part)."""
    def of(t):
        g = grads[id(t)]
        return torch.zeros_like(t) if g is None else g

    if isinstance(leaf, Placed):
        return leaf.map(of)
    return of(leaf)


def _allreduce_replicas(g):
    """The data-parallel all-reduce of a placed gradient, in a fixed
    order: where a block is held on several devices (a replicated block),
    its per-device gradients are added in float32 in mesh-coordinate order
    on the first one's device, and the sum is copied back to each.

    The moves are recorded (``nn.coords``) by coordinate, as a mesh of
    distinct devices makes them: every coordinate holding a block sends
    its gradient to the block's first coordinate and receives the sum,
    whether or not the coordinates share a device (and so a tensor)."""
    if not isinstance(g, Placed):
        return g
    holders = {}
    for c, t in g.blocks.items():
        holders.setdefault(g.placement.block_index(c), []).append(
            (c, t.numel() * t.element_size()))
    coords.record("all-reduce", [
        m for cs in holders.values() for c, n in cs[1:]
        for m in ((c, cs[0][0], n), (cs[0][0], c, n))])
    copies = {}
    for c, t in g.unique():
        copies.setdefault(g.placement.block_index(c), []).append((c, t))
    made = {}
    with coords.quiet():
        for cts in copies.values():
            if len(cts) < 2:
                continue
            c0, t0 = cts[0]
            with coords.forced((c0,)):
                acc = t0.float()
                for _, t in cts[1:]:
                    acc = acc + t.to(t0.device, torch.float32)
                acc = acc.to(t0.dtype)
            for c, t in cts:  # the sum held by every copy's device
                with coords.forced((c,)):
                    made[id(t)] = acc.to(t.device, copy=t is not t0)
    out = g if not made else Placed(
        g.placement, g.shape, g.dtype,
        {c: made.get(id(t), t) for c, t in g.blocks.items()})
    for t, cs in out.holders():  # the sum lives at every holder
        coords.tag(t, cs)
    return out


def _value_and_grad(fn, params, batch):
    """``((loss, metrics), grads)`` of ``fn(params, batch)``, the grads in
    the leaves' dtypes (placed leaves' per block, replicas all-reduced);
    nothing of the graph outlives the call."""
    leaves = tree_map(_fresh, params)
    loss, metrics = fn(leaves, batch)
    flat = [t for leaf in tree_leaves(leaves) for t in _distinct(leaf)]
    g = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): gt for t, gt in zip(flat, g)}
    grads = tree_map(lambda leaf: _allreduce_replicas(
        _with_grads(leaf, by_id)), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def _zeros_f32(p):
    if isinstance(p, Placed):
        return p.map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _add_f32(a, b):
    if isinstance(a, Placed):
        return a.map(lambda x, y: x + y.float(), b)
    return a + b.float()


def _div(a, n: int):
    if isinstance(a, Placed):
        return a.map(lambda x: x / n)
    return a / n


def _constrain(g, placement):
    """``g`` re-placed onto ``placement`` (``with_sharding_constraint``)."""
    if isinstance(g, Placed):
        return g.replace(placement)
    return Placed.place(g, placement)


def make_train_step(cfg, mesh, ocfg: AdamWConfig, bf16_grads: bool = False,
                    rule_overrides=None, grad_shardings=None,
                    explicit_rs: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``ce``, ``z``, ``grad_norm`` and ``lr`` (and
    the transformers' ``load_balance`` and ``router_z``, 0 without MoE).

    The float32 master parameters are cast to bfloat16 inside the
    differentiated function, so their gradients come back float32;
    ``bf16_grads`` differentiates with respect to the cast tree instead,
    so the 2-D and larger gradients are bfloat16 (the optimizer widens
    them).  With ``cfg.grad_accum = n > 1`` the batch is split into ``n``
    microbatches along its first axis, their gradients summed in float32
    and divided by ``n``, and the loss and metrics averaged.  The given
    parameters and state are not changed.

    With a ``mesh`` (``launch.mesh.Mesh``) the parameters (and the state)
    are placed (``nn.module.place``) and the loss runs under
    ``make_ctx(mesh, rule_overrides, explicit_rs=explicit_rs)``: the
    per-shard bodies of the dense, audio, vlm, Mamba and hybrid families
    and the MoE family's expert-parallel schedules (``nn.moe``; the
    gradients flow back through the all-to-all's device moves).  The
    gradients are taken
    with respect to the placed blocks; a block replicated on several
    devices has its gradients added in float32 in mesh order on its first
    device and copied back (the data-parallel all-reduce).
    ``grad_shardings`` (a tree of placements, e.g. ``nn.module.shardings``
    of ``adamw_init_specs(..., remap_axes=...)["m"]``: ZeRO-1) re-places
    the gradients before the update; ``explicit_rs`` routes the blocks'
    row-parallel ``wo``/``wd`` through ``nn.layers.row_parallel``."""
    model = build_model(cfg)
    ctx = make_ctx(mesh, rule_overrides, explicit_rs=explicit_rs)

    def loss_fn(p, b):
        return model.loss(_cast_tree_bf16(p), b, ctx=ctx)

    def loss_fn_bf16(pc, b):
        return model.loss(pc, b, ctx=ctx)

    def grad_of(params, b):
        if bf16_grads:
            return _value_and_grad(loss_fn_bf16, _cast_tree_bf16(params), b)
        return _value_and_grad(loss_fn, params, b)

    def train_step(params, opt_state, batch):
        n = max(cfg.grad_accum, 1)
        if n == 1:
            (loss, metrics), grads = grad_of(params, batch)
        else:
            grads = tree_map(_zeros_f32, params)
            loss, ms = 0.0, []
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, m), g = grad_of(params, mb)
                grads = tree_map(_add_f32, grads, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: _div(g, n), grads)
            loss = loss / n
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if grad_shardings is not None:
            grads = tree_map(_constrain, grads, grad_shardings)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                                   ocfg)
        return new_params, new_opt, dict(metrics, loss=loss, **om)

    return train_step


def make_prefill_step(cfg, mesh=None, rule_overrides=None):
    """``prefill_step(params, batch) -> (logits [B, Vp], cache)`` (placed
    parameters in, a placed cache out under a mesh)."""
    model = build_model(cfg)
    ctx = make_ctx(mesh, rule_overrides)

    def prefill_step(params, batch):
        return model.prefill(params, batch, ctx=ctx)

    return prefill_step


def make_decode_step(cfg, mesh=None, rule_overrides=None):
    """``serve_step(params, cache, tokens [B, 1]) -> (logits [B, Vp],
    new cache)``; the padded vocabulary's logits are set to -1e30, so a
    padded id is never sampled."""
    model = build_model(cfg)
    ctx = make_ctx(mesh, rule_overrides, decode=True)

    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens, ctx=ctx)
        if cfg.padded_vocab > cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
        return logits, new_cache

    return serve_step


def active_matmul_params(cfg) -> int:
    """N of ``MODEL_FLOPS = 6 N D``: the parameters a token's matmuls touch.
    The embedding gather is left out, the logits projection counted once
    (tied or not), and each expert tensor at ``top_k`` of its padded
    experts (the dead padding experts are never routed)."""
    import math

    from repro_torch.nn.module import ParamSpec

    def walk(tree, path):
        if isinstance(tree, ParamSpec):
            yield path, tree
        else:
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")

    total = 0.0
    for name, spec in walk(build_model(cfg).param_specs(), ""):
        n = math.prod(spec.shape)
        if "embed/embedding" in name:
            continue
        if "/moe/" in name and name.split("/")[-1] in ("w_gate", "w_up",
                                                       "w_down"):
            n *= cfg.moe.top_k / cfg.moe.padded_experts
        total += n
    if cfg.tie_embeddings:
        total += cfg.d_model * cfg.padded_vocab
    return int(total)
