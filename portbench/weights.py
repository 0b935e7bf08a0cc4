"""Seeded inputs: parameters made on the device in one draw, and the seeds
of each stream derived from ``--seed``."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream (weights, images, calibration,
    prompts, the correctness sample) of run seed ``seed``; any whole
    ``seed`` of either sign."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed < 0)] + [ord(c) for c in stream]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream))
    return g


def make(layout: List[tuple], seed: int, device) -> Dict:
    """The parameter tree of ``layout`` (``(path, shape, init, std)``
    entries, ``/`` between the keys of a path) in float32 on ``device``:
    every ``"normal"`` leaf is cut from one standard-normal draw and scaled
    by its ``std``; ``"ones"`` and ``"zeros"`` leaves are constant."""
    g = generator(seed, "weights", device)
    n = sum(math.prod(s) for _, s, init, _ in layout if init == "normal")
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    tree: Dict = {}
    at = 0
    for path, shape, init, std in layout:
        if init == "normal":
            size = math.prod(shape)
            leaf = flat[at:at + size].view(shape).mul(std)
            at += size
        elif init == "ones":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def shapes(tree, prefix: str = "") -> Dict[str, tuple]:
    """``{path: shape}`` of a nested tree of tensors (or of objects with a
    ``shape``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}
