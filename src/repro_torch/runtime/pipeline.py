"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (port of
``repro.runtime.pipeline``).

The mesh is one process over an explicit device list (``launch.mesh``):
stage ``s`` holds its slice of the stacked per-stage parameters on the
axis's device ``s``.  Microbatches enter at stage 0 and each stage's output
is copied to the next stage's device; the schedule runs ``M + S - 1``
ticks (fill and drain), a stage computing at a tick only when its slot
holds a live microbatch (the reference computes the idle slots too and
discards them; the results are the same).  The last stage's outputs come
back on the axis's first device.  Every step is a tensor operation, so
autograd differentiates the whole schedule (the reverse ring is the
copies' backward).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.nn import coords

__all__ = ["pipeline_apply"]


def _stage_slice(tree, s: int, dev, coord):
    """Stage ``s``'s parameters on ``dev``: index ``s`` of a whole tensor's
    leading stage dim, or the block a placed leaf (``nn.module.Placed``,
    its leading dim over the stage axis) keeps at ``coord``."""
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s, dev, coord) for k, v in tree.items()}
    if hasattr(tree, "blocks"):
        blk = tree.local(coord)
        return blk[s - tree.ranges(coord)[0][0]].to(dev)
    return tree[s].to(dev)


def pipeline_apply(fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage"):
    """Run the ``x`` microbatches through ``S`` pipeline stages.

    fn: ``(params_slice, act [B, ...]) -> act [B, ...]`` (one stage's
    compute); stage_params: a tree whose leaves have a leading stage dim
    ``S``; x: ``[M, B, ...]`` microbatches.  Returns ``[M, B, ...]``: the
    last stage's outputs, on the axis's first device."""
    devs = [torch.device(d) for d in mesh.axis_devices(axis)]
    S, M = len(devs), x.shape[0]
    names = mesh.axis_names
    k = names.index(axis)
    cs = []
    for s in range(S):
        c = [0] * len(names)
        c[k] = s
        cs.append(tuple(c))
    params = []
    for s in range(S):
        with coords.at((cs[s],)):
            params.append(_stage_slice(stage_params, s, devs[s], cs[s]))
    inbuf = [None] * S
    outs = [None] * M
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue
            with coords.at((cs[s],)):
                a_in = x[mb].to(devs[s]) if s == 0 else inbuf[s]
                y = fn(params[s], a_in)
            nxt_s = 0 if s == S - 1 else s + 1  # the stage hand-off
            with coords.at((cs[nxt_s],)), \
                    coords.kind("collective-permute"):
                moved = y.to(devs[nxt_s])
            if s == S - 1:
                outs[mb] = moved
            else:
                nxt[s + 1] = moved
        inbuf = nxt
    with coords.at((cs[0],)):
        return torch.stack(outs)
