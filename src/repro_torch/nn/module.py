"""Declarative parameters (port of ``repro.nn.module``'s ParamSpec,
``materialize`` and ``count_params``), layer views of a stacked tree, and
the activation-checkpoint policies the training losses apply per layer.

A model declares its parameters as a tree of :class:`ParamSpec` (shape,
dtype, init recipe); :func:`materialize` draws them.  Each leaf draws from a
numpy generator seeded by ``(seed, crc32(path))``, so a leaf's values depend
on the seed and its place in the tree only.  The numbers differ from the JAX
package's (other generator); parity tests carry the JAX parameters across
instead (``repro_torch.interop.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.interop import resolve_device

__all__ = ["ParamSpec", "materialize", "stack_specs", "count_params",
           "layer_view", "remat"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape + init recipe (fan_in | normal | embed | zeros
    | ones) + scale."""

    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "fan_in"
    scale: float = 1.0


def _draw(spec: ParamSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.init == "zeros":
        return np.zeros(spec.shape, np.float32)
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    if spec.init in ("normal", "embed"):
        return rng.standard_normal(spec.shape, np.float32) * spec.scale
    if spec.init == "fan_in":
        # the reference's recipe, stacked layer axis included in the fan-in
        fan_in = spec.shape[0] if len(spec.shape) == 1 else \
            math.prod(spec.shape[:-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return rng.standard_normal(spec.shape, np.float32) * np.float32(std)
    raise ValueError(f"unknown init {spec.init}")


def materialize(specs, seed: int = 0, *, device="cuda", _path: str = ""):
    """Concrete parameters for a spec tree (nested dicts of ParamSpec)."""
    dev = resolve_device(device)
    if isinstance(specs, ParamSpec):
        rng = np.random.default_rng([seed, zlib.crc32(_path.encode())])
        arr = np.ascontiguousarray(_draw(specs, rng), np.float32)
        return torch.from_numpy(arr).to(device=dev, dtype=specs.dtype)
    return {k: materialize(v, seed, device=dev, _path=f"{_path}/{k}")
            for k, v in specs.items()}


def stack_specs(tree, n: int):
    """Prepend a stacked ``layers`` dim to every ParamSpec in the tree."""
    if isinstance(tree, ParamSpec):
        return dataclasses.replace(tree, shape=(n, *tree.shape))
    return {k: stack_specs(v, n) for k, v in tree.items()}


def count_params(specs) -> int:
    """The number of parameters a spec tree declares."""
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def layer_view(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, l) for k, v in tree.items()}
    return tree[l]


#: the matmuls ``"dots"`` keeps (JAX's ``dots_with_no_batch_dims_saveable``:
#: contractions without batch dimensions; ``bmm`` has one)
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    saved = {getattr(torch.ops.aten, n).default for n in _DOTS}
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under an activation-checkpoint policy (the reference's
    ``remat_policy``): ``"none"`` keeps every activation; ``"full"`` keeps
    only ``fn``'s inputs and recomputes the rest in the backward pass
    (``jax.checkpoint_policies.nothing_saveable``); ``"dots"`` keeps the
    outputs of the matmuls without batch dimensions and recomputes the rest
    (``dots_with_no_batch_dims_saveable``).  The forward values do not
    depend on the policy."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r} (none | dots | full)")
