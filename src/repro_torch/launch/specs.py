"""Meta-tensor stand-ins for every input of a step: the dry run's food
(port of ``repro.launch.specs``).

``input_specs(arch, shape, mesh)`` returns what a step consumes as meta
tensors (shape and dtype, nothing allocated), each carrying its placement
on ``mesh`` as ``.sharding`` (``nn.module.TablePlacement``; None without a
mesh): a 400B-parameter cell is laid out on a CPU host.
:func:`step_args` turns such a tree into the arguments the port's steps
take: each placed leaf a ``nn.module.Placed`` of meta blocks (one a block
index, shared by the coordinates holding it, as a mesh of one device
holds them), the others as they are.

Shapes follow the reference: ``train_*``/``prefill_*`` provide
``[global_batch, seq]`` token grids (and the stub modality embeddings);
``decode_*`` one new token and a filled KV cache of ``seq_len`` (a
rolling-window config caps its buffer at the window; the Mamba families
carry constant-size states).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.nn.module import (DEFAULT_RULES, Placed, ShardingRules,
                                   TablePlacement, logical_to_partition_spec,
                                   shape_structs)

__all__ = ["input_specs", "batch_specs", "param_structs", "data_spec",
           "step_args"]


def _struct(shape, dtype, mesh, rules, axes) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.sharding = None if mesh is None else TablePlacement(
        mesh, logical_to_partition_spec(axes, shape, rules))
    return t


def data_spec(mesh, rule_overrides=None) -> Optional[ShardingRules]:
    """The rules of ``mesh``: :data:`~repro_torch.nn.module.DEFAULT_RULES`
    updated by ``rule_overrides`` (None without a mesh)."""
    if mesh is None:
        return None
    rules = dict(DEFAULT_RULES)
    if rule_overrides:
        rules.update(rule_overrides)
    return ShardingRules.for_mesh(mesh, rules)


def batch_specs(cfg, shape_name: str, mesh, rule_overrides=None):
    """The training / prefill batch of one (config, shape): ``tokens``
    (``labels`` and ``loss_mask`` to train; whisper's ``memory``, llava's
    ``img_embeds``)."""
    sh = SHAPES[shape_name]
    rules = data_spec(mesh, rule_overrides)
    B, S = sh.global_batch, sh.seq_len
    tok_axes = ("batch", None)
    n_text = S - cfg.n_img_tokens if cfg.n_img_tokens else S
    out = {"tokens": _struct((B, n_text), torch.int32, mesh, rules,
                             tok_axes)}
    if sh.kind == "train":
        out["labels"] = _struct((B, n_text), torch.int32, mesh, rules,
                                tok_axes)
        out["loss_mask"] = _struct((B, n_text), torch.float32, mesh, rules,
                                   tok_axes)
    if cfg.encoder_layers:
        out["memory"] = _struct((B, cfg.encoder_len, cfg.d_model),
                                torch.float32, mesh, rules,
                                ("batch", None, None))
    if cfg.n_img_tokens:
        out["img_embeds"] = _struct((B, cfg.n_img_tokens, cfg.d_model),
                                    torch.float32, mesh, rules,
                                    ("batch", None, None))
    return out


def input_specs(arch: str, shape_name: str, mesh, cfg=None,
                rule_overrides=None, zero1: bool = False) -> Dict[str, Any]:
    """Everything a step consumes, as meta tensors:

    train -> {params, opt_state, batch}; prefill -> {params, batch};
    decode -> {params, cache, tokens}.

    ``zero1``: the moments take ``"opt_embed"`` where the parameters have
    ``"embed"`` (with the rule override ``{"embed": None, "opt_embed":
    ("data", "pod")}`` the parameters replicate over the data axes and the
    moments shard there).  A llama4 config quantizes its moments (int8
    codes and row scales)."""
    cfg = cfg or get_config(arch)
    sh = SHAPES[shape_name]
    model = build_model(cfg)
    rules = data_spec(mesh, rule_overrides)
    pspecs = model.param_specs()
    params = shape_structs(pspecs, mesh, rules)
    if sh.kind == "train":
        from repro_torch.optim import AdamWConfig, adamw_init_specs

        ocfg = AdamWConfig(quantize_moments=cfg.name.startswith("llama4"))
        ospecs = adamw_init_specs(
            pspecs, ocfg, remap_axes={"embed": "opt_embed"} if zero1 else None)
        return {"params": params,
                "opt_state": shape_structs(ospecs, mesh, rules),
                "batch": batch_specs(cfg, shape_name, mesh, rule_overrides)}
    if sh.kind == "prefill":
        return {"params": params,
                "batch": batch_specs(cfg, shape_name, mesh, rule_overrides)}
    cache = shape_structs(model.cache_specs(sh.global_batch, sh.seq_len),
                          mesh, rules)
    tokens = _struct((sh.global_batch, 1), torch.int32, mesh, rules,
                     ("batch", None))
    return {"params": params, "cache": cache, "tokens": tokens}


def param_structs(cfg, mesh):
    """The parameters of ``cfg`` as meta tensors placed by the default
    rules."""
    return shape_structs(build_model(cfg).param_specs(), mesh)


def _placed(t: torch.Tensor):
    p = getattr(t, "sharding", None)
    if p is None or t.dim() == 0:  # a step count, a cache position
        return t

    def block(index, dev):
        shape = [b - a for a, b in p.block_ranges(t.shape, index)]
        return torch.empty(shape, dtype=t.dtype, device=dev)

    return Placed.build(p, t.shape, t.dtype, block)


def step_args(tree):
    """A tree of :func:`input_specs` as a step's arguments: each placed
    leaf of the parameters, optimizer state and cache a ``Placed`` of
    blocks on its mesh's devices (empty: on a ``meta`` mesh nothing is
    allocated); the batch, the decode tokens and the 0-d leaves (the
    optimizer's count, the cache's position) stay whole meta tensors, as
    the port's steps take them (each row's block cut from them)."""
    if isinstance(tree, dict):
        return {k: v if k in ("batch", "tokens") else step_args(v)
                for k, v in tree.items()}
    return _placed(tree)
