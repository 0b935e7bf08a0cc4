"""Compressed cross-replica gradient reduction (port of
``repro.optim.compress``) on the single-process mesh (``launch.mesh``).

``x`` is a ``nn.module.Placed`` of shape ``[n, *shape]`` whose dim 0 is cut
over the mesh axis ``axis`` into its ``n`` shards and whose other dims
replicate: block ``i`` is shard ``i``'s local value, on shard ``i``'s
device (the stacked array the reference's test hands ``shard_map`` with
``in_specs=P(axis)``).  A placed leaf rather than a list of tensors,
because it names its mesh: ``axis`` is then a real mesh axis, and the shard
count, the devices and the replicas along the other axes come from it.

Every scheme is a two-phase reduction over equal chunks of the flattened
value (padded to a multiple of ``n``), the pattern of a ring all-reduce:
shard ``j`` receives chunk ``j`` of every source, adds the sources in
float32 in source order and divides by ``n`` (reduce-scatter), and the
reduced chunks are then gathered by every shard (all-gather):

* ``int8`` follows the reference's ``_int8_pmean`` step by step: one scale
  per chunk, ``max|chunk| / 127 + 1e-12`` (the division by a constant
  taken as XLA compiles it, a multiplication by the reciprocal); codes
  ``clip(round(chunk / scale), -127, 127)`` (a true division,
  round-half-even); the chunks' int8 codes and scales move to their
  owners, which requantize their reduced chunk (one scale) before the
  all-gather moves int8 again;
* ``bf16`` moves bfloat16: the mean is taken in float32, rounded once to
  bfloat16 (the reference's bfloat16 ``pmean``), gathered and widened;
* ``none`` moves float32: the float32 mean in shard order.

Returns ``(reduced, residual)``: ``reduced`` a replicated ``Placed`` of
``shape`` (float32, one copy a distinct device), ``residual`` a
``Placed`` like ``x`` whose block ``i`` is shard ``i``'s ``x_i - Q(x_i)``
(zeros for ``none``).  The residual is returned, not applied: as in the
reference, no train step folds it into the next step's gradient.

Given ``stats`` (a dict the caller keeps), a call adds to
``stats["sent_bytes"]`` the bytes that leave each shard's device block
for another shard in the two phases (codes, scales and values; a shard's
own chunk stays), summed over the shards.  On a mesh whose shards share a
device the moves are copies on that device, counted all the same.  The
same moves go to the move record (``nn.coords``): phase 1 as a
``reduce-scatter``, phase 2 as an ``all-gather``, each between two shards'
coordinates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.nn import coords
from repro_torch.nn.module import Placed, TablePlacement

__all__ = ["compressed_pmean", "compress_grads_tree"]

#: the reference's ``/ 127.0`` as XLA compiles a division by a constant: a
#: multiplication by the float32 reciprocal (the quantize itself, ``v /
#: scale``, stays a true division); likewise ``/ n`` below
_INV127 = 1.0 / 127

#: the bytes one element of a chunk moves, by scheme
_WIRE = {"int8": 1, "bf16": 2, "none": 4}


def _shards(x: Placed, axis: str) -> Tuple[List[torch.Tensor],
                                           List[torch.device], List[Tuple]]:
    """Each shard's local value (float32, on its device), the devices and
    the mesh coordinates, in shard order."""
    mesh = x.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    n = int(mesh.shape[axis])
    if x.spec[0] != axis or x.shape[0] != n or any(x.spec[1:]):
        raise ValueError(f"x must stack one value per {axis!r} shard on dim "
                         f"0 ([{n}, ...] with spec ({axis!r}, None, ...)); "
                         f"got {tuple(x.shape)} with spec {x.spec}")
    k = mesh.axis_names.index(axis)
    cs = []
    for i in range(n):
        c = [0] * len(mesh.axis_names)
        c[k] = i
        cs.append(tuple(c))
    values = []
    for c in cs:
        with coords.at((c,)):
            values.append(x.blocks[c][0].float())
    return values, [torch.device(mesh.devices[c]) for c in cs], cs


def _chunks(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v`` flattened, zero-padded to a multiple of ``n``, ``[n, C]``."""
    flat = v.reshape(-1)
    pad = (-flat.numel()) % n
    return torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1)


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def _int8_codes(flats, devs, cs=None):
    """The int8 scheme's codes: each source's ``(codes [n, C], scales [n,
    1])`` and, per owner ``j``, its reduced chunk requantized ``(codes
    [C], scale)`` on its device (phase 1: the sources' chunk ``j`` moved
    to ``devs[j]`` and added as ``q * s`` in float32 in source order);
    ``cs`` the shards' mesh coordinates (default ``(i,)``)."""
    n = len(flats)
    cs = cs or [(i,) for i in range(n)]
    scales, qs = [], []
    for f, c in zip(flats, cs):
        with coords.forced((c,)):
            scales.append(f.abs().amax(1, keepdim=True) * _INV127 + 1e-12)
            qs.append(_quantize(f, scales[-1]))
    owned = []
    for j, dev in enumerate(devs):
        with coords.forced((cs[j],)):
            acc = qs[0][j].to(dev).float() * scales[0][j].to(dev)
            for i in range(1, n):
                acc = acc + qs[i][j].to(dev).float() * scales[i][j].to(dev)
            part = acc * (1.0 / n)
            s2 = part.abs().max() * _INV127 + 1e-12
            owned.append((_quantize(part, s2), s2))
    return qs, scales, owned


def _reduce(locals_, devs, scheme, stats, cs):
    """The two phases (the shards at mesh coordinates ``cs``).  Returns
    (``gathered(dev)``: every owner's reduced chunk on ``dev``, ``[n, C]``
    float32; each shard's residual ``[n, C]``).  The moves are recorded
    (``nn.coords``) by coordinate: phase 1 a reduce-scatter, phase 2 an
    all-gather to every shard."""
    n = len(locals_)
    flats = [_chunks(v, n) for v in locals_]
    C = flats[0].shape[1]
    chunk = C * _WIRE[scheme] + (4 if scheme == "int8" else 0)
    pairs = [(cs[i], cs[j], chunk) for j in range(n) for i in range(n)]
    coords.record("reduce-scatter", pairs)
    coords.record("all-gather", pairs)
    with coords.quiet():
        if scheme == "int8":
            qs, scales, owned = _int8_codes(flats, devs, cs)
            resid = []
            for f, q, s, c in zip(flats, qs, scales, cs):
                with coords.forced((c,)):
                    resid.append(f - q.float() * s)
        else:
            wire = torch.bfloat16 if scheme == "bf16" else torch.float32
            sent, resid = [], []
            for f, c in zip(flats, cs):
                with coords.forced((c,)):
                    sent.append(f.to(wire))
                    resid.append(f - sent[-1].float())
            owned = []
            for j, dev in enumerate(devs):
                with coords.forced((cs[j],)):
                    acc = sent[0][j].to(dev).float()
                    for i in range(1, n):
                        acc = acc + sent[i][j].to(dev).float()
                    owned.append(((acc * (1.0 / n)).to(wire), None))
    if stats is not None:  # both phases, every shard
        per_shard = (n - 1) * chunk
        stats["sent_bytes"] = stats.get("sent_bytes", 0) + 2 * n * per_shard

    def gathered(dev):
        # phase 2: every owner's reduced chunk (and scale) to ``dev``, at
        # the coordinates holding the result (``Placed.build``'s scope)
        with coords.quiet(), coords.forced(coords.current() or cs[:1]):
            return torch.stack([q.to(dev).float() * (1.0 if s is None
                                                     else s.to(dev))
                                for q, s in owned])

    return gathered, resid


def compressed_pmean(x: Placed, axis: str, scheme: str = "int8", *,
                     stats: Optional[Dict] = None):
    """The mean over mesh axis ``axis`` of ``x``'s per-shard values,
    reduced by ``scheme`` (``"int8"``, ``"bf16"``, ``"none"``; module
    docstring).  Returns ``(reduced, residual)``."""
    locals_, devs, cs = _shards(x, axis)
    if scheme not in _WIRE:
        raise ValueError(f"unknown compression scheme {scheme!r}")
    shape = x.shape[1:]
    N = locals_[0].numel()
    gathered, resid = _reduce(locals_, devs, scheme, stats, cs)
    rank = len(x.spec)
    made = {}

    def whole(index, dev):
        if dev not in made:
            made[dev] = gathered(dev).reshape(-1)[:N].reshape(shape)
        return made[dev]

    reduced = Placed.build(TablePlacement(x.mesh, (None,) * (rank - 1)),
                           shape, torch.float32, whole)

    def residual(index, dev):
        return resid[index[0]].reshape(-1)[:N].reshape(shape)[None].to(dev)

    return reduced, Placed.build(x.placement, x.shape, torch.float32,
                                 residual)


def compress_grads_tree(grads, axis: str, scheme: str = "int8", *,
                        stats: Optional[Dict] = None):
    """:func:`compressed_pmean` of every leaf of a tree of dicts; returns
    ``(reduced, residuals)``, two trees of its structure."""
    if not isinstance(grads, dict):
        return compressed_pmean(grads, axis, scheme, stats=stats)
    pairs = {k: compress_grads_tree(v, axis, scheme, stats=stats)
             for k, v in grads.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})
