"""Device meshes (port of ``repro.launch.mesh``'s host and decode meshes).

The reference is one process that maps ``shard_map`` over its local devices
and combines partial sums with ``psum``.  The port's serving stack is one
process too, so its mesh is a **single-process device mesh**: an explicit
grid of ``torch.device``s with named axes, and nothing of
``torch.distributed``.  A table sharded over an axis is a list of
contiguous per-device blocks, each kept on its device
(``core.pcilt.ShardedTables``, ``core.pcilt.ShardedSharedPool``); a
parameter or cache leaf is a ``nn.module.Placed`` (one block a mesh
coordinate, placed by ``nn.module.shardings``), and the layers run their
per-shard bodies under a ``nn.layers.Ctx``.  Each shard's partial sum is
computed on its device in float32, moved to the axis's first device and
added there in shard order (a fixed order: no atomics).  :func:`make_mesh`
names any axes (``("stage",)`` for ``runtime.pipeline_apply``).  The same
mesh carries expert parallelism (``nn.moe``'s all-to-all and psum
schedules, the tiled all-to-all a set of device moves between the model
shards) and the compressed gradient reduction (``optim.compress``).  No
multi-process form is planned: the reference is one process as well (it
has no ``jax.distributed``).  :func:`make_production_mesh` lays out the
reference's production meshes, 256 and 512 coordinates; the dry run
(``launch.dryrun``) builds them over ``meta`` devices, where nothing is
allocated.

A mesh never falls back to the CPU: without ``devices=`` it spans CUDA
cards, and asking for more shards than there are cards raises.  An explicit
``devices=`` list may repeat a device: ``make_decode_mesh(4,
devices=[torch.device("cuda:0")] * 4)`` runs four shards on one card (each
shard's kernel at its local shape, then the reduction), and the CPU tests
build meshes of ``"cpu"`` devices the same way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_host_mesh",
           "make_decode_mesh"]


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

    @functools.cached_property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @functools.cached_property
    def coords(self) -> List[Tuple[int, ...]]:
        """Every mesh coordinate, in order."""
        return [tuple(int(i) for i in c)
                for c in np.ndindex(*self.devices.shape)]

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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` with named axes over the first ``prod(shape)``
    CUDA cards, or over ``devices`` (exactly that many, repeats allowed):
    ``make_mesh((4,), ("stage",))`` is ``pipeline_apply``'s stage mesh."""
    n = int(np.prod(shape))
    if n < 1:
        raise ValueError(f"mesh shape {tuple(shape)} has no devices")
    if devices is None:
        devs = _cards(n)
    else:
        devs = [_indexed(torch.device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {tuple(shape)} mesh takes {n} devices, "
                             f"got {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(tuple(int(s) for s in shape)),
                tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``
    (the pod axis one more data-parallel axis: the batch shards over
    ``("pod", "data")``).  Over the first 256 (512) CUDA cards, raising
    when there are fewer, or over ``devices`` (the dry run passes
    ``[torch.device("meta")] * n``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` CUDA cards,
    or over ``devices`` (exactly ``data * model`` of them, repeats
    allowed)."""
    return make_mesh((int(data), int(model)), ("data", "model"),
                     devices=devices)


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
