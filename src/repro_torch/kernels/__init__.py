"""repro_torch.kernels — hand-written CUDA kernels for the PCILT hot path.

* ``csrc/`` — the CUDA C++ sources for ``sm_90a``: the fused GEMV (one
  kernel with a segment stride, a layer offset and a pack width, launched
  unstacked, layer-stacked, paired and paired stacked), the fused and
  host-packed depthwise conv1d and the shared-pool fused GEMV (each a
  template over the table dtype, float32 or bfloat16, and, where the
  reference has one, a counters flag); the fused and shared-pool conv2d;
  the host-packed GEMV, which also serves the host-packed conv2d; the
  CRC-32 of table bytes (the integrity record and the health monitor's
  checks);
* ``build.py`` — ``nvcc`` into one shared library per source, loaded with
  ``ctypes`` at first use (``KERNELS`` maps each kernel to its library);
* ``ops.py`` — the wrappers (checks, launch, launch counts) and each
  kernel's plain PyTorch version, which runs for CPU tensors;
* ``ref.py`` — oracles of the fetch on host-packed offsets.
"""

from . import ops, ref  # noqa: F401

__all__ = ["ops", "ref"]
