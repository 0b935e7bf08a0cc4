"""Device meshes (port of ``repro.launch.mesh``'s host and decode meshes).

The reference is one process that maps ``shard_map`` over its local devices
and combines partial sums with ``psum``.  The port's serving stack is one
process too, so its mesh is a **single-process device mesh**: an explicit
grid of ``torch.device``s with named axes, and nothing of
``torch.distributed``.  A table sharded over an axis is a list of
contiguous per-device blocks, each kept on its device
(``core.pcilt.ShardedTables``, ``core.pcilt.ShardedSharedPool``); each
shard's partial sum is computed on its device in float32, moved to the
axis's first device and added there in shard order (a fixed order: no
atomics).  The multi-process ``torch.distributed`` form belongs with the
training distribution, which is not ported yet; so is
``make_production_mesh`` (the reference's v5e pods of 256 and 512 chips,
which waits for the ``dryrun``/``specs`` slice).

A mesh never falls back to the CPU: without ``devices=`` it spans CUDA
cards, and asking for more shards than there are cards raises.  An explicit
``devices=`` list may repeat a device: ``make_decode_mesh(4,
devices=[torch.device("cuda:0")] * 4)`` runs four shards on one card (each
shard's kernel at its local shape, then the reduction), and the CPU tests
build meshes of ``"cpu"`` devices the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_host_mesh", "make_decode_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes: ``devices`` is a numpy object
    array of ``torch.device`` of shape ``tuple(shape.values())``, its axes
    named by ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid needs as "
                             f"many axis names, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        the shards of a table sharded over ``axis`` live, in shard order."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _cards(n: int) -> List[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} CUDA cards, this host has "
            f"{have}; pass devices= to place several shards on one device "
            f"(e.g. [torch.device('cuda:0')] * {n}, or 'cpu' devices)")
    return [torch.device("cuda", i) for i in range(n)]


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` CUDA cards,
    or over ``devices`` (exactly ``data * model`` of them, repeats
    allowed)."""
    n = int(data) * int(model)
    if n < 1:
        raise ValueError(f"mesh shape ({data}, {model}) has no devices")
    if devices is None:
        devs = _cards(n)
    else:
        devs = [_indexed(torch.device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a ({data}, {model}) mesh takes {n} devices, "
                             f"got {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(int(data), int(model)), ("data", "model"))


def make_decode_mesh(model: int = 0, *,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Tensor-parallel decode mesh: ``model`` devices on the ``"model"``
    axis, ``data=1``.  ``model=0`` spans every CUDA card (or every device
    of ``devices``).  What shards is the weight state: each PCILT table's
    segment axis over ``"model"`` (``nn.module.DEFAULT_RULES``
    ``"table_seg"``), one reduction of partial sums a layer."""
    if not model:
        if devices is not None:
            model = len(devices)
        else:
            model = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if model < 1:
                raise RuntimeError("make_decode_mesh(model=0) spans the CUDA "
                                   "cards and this host has none; pass "
                                   "devices= to build a mesh elsewhere")
    return make_host_mesh(1, model, devices=devices)
