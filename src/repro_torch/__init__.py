"""repro_torch — the PCILT reproduction in PyTorch, with CUDA kernels for Hopper.

A port of ``src/repro`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  Module
names mirror ``src/repro`` so each part has an obvious counterpart; the JAX
package stays the reference the parity tests hold this one to.

The package never imports ``jax``.  Every entry point takes ``device=``
(default ``"cuda"``) and raises when CUDA is absent unless the caller asked
for ``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.
"""
