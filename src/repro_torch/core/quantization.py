"""Low-cardinality quantization for PCILT (port of ``repro.core.quantization``).

Codes are unsigned integers in ``[0, K)`` with ``K = 2**bits``; the value a
code stands for is ``(code - zero_point) * scale``.  ``quantize`` is
``clip(round_half_even(x / scale) + zero_point, 0, K - 1)`` with a true
division — the arithmetic every kernel of the port repeats bit for bit.

Dtype rule, as in the reference: a tensor scale promotes the division the
way ``jnp`` does (``bf16 / f32 -> f32``), so the scale is never silently
rounded to the activation dtype.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantSpec", "scale_from_amax", "calibrate", "quantize", "quantize_with_stats",
           "dequantize", "fake_quant", "code_values"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantization grid (``bits`` in 1..8;
    ``symmetric`` puts zero mid-range for signed data)."""

    bits: int = 4
    symmetric: bool = False

    def __post_init__(self):
        if not (1 <= self.bits <= 8):
            raise ValueError(f"PCILT targets 1..8 bit cardinality, got {self.bits}")
        if self.bits == 1 and self.symmetric:
            raise ValueError("1-bit quantization must be asymmetric (boolean)")

    @property
    def cardinality(self) -> int:
        return 1 << self.bits

    @property
    def zero_point(self) -> int:
        return (self.cardinality // 2) if self.symmetric else 0

    @property
    def storage_dtype(self):
        return torch.uint8


def scale_from_amax(amax, spec: QuantSpec) -> torch.Tensor:
    """Observed absmax -> float32 quantization scale on ``spec``'s grid."""
    if spec.symmetric:
        span = max(spec.cardinality - 1 - spec.zero_point, 1)
    else:
        span = spec.cardinality - 1
    return torch.clamp_min(torch.as_tensor(amax, dtype=torch.float32),
                           1e-8) / span


def calibrate(x: torch.Tensor, spec: QuantSpec, axis=None) -> torch.Tensor:
    """Absmax scale mapping the observed range onto the code grid: ``|x|``
    on a symmetric grid, ``max(x, 0)`` on an asymmetric one; ``axis``
    (kept as size-1 dims) calibrates per channel."""
    a = x.abs() if spec.symmetric else torch.clamp_min(x, 0.0)
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return scale_from_amax(amax, spec)


def _scale_like(scale, x: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(scale, device=x.device)
    return s if s.is_floating_point() else s.float()


def _pre_clip(x: torch.Tensor, spec: QuantSpec, scale) -> torch.Tensor:
    """``round(x / scale) + zero_point`` before the clip, in the promoted
    float dtype of ``x`` and ``scale``."""
    s = _scale_like(scale, x)
    dt = torch.promote_types(x.dtype, s.dtype)
    return torch.round(x.to(dt) / s.to(dt)) + spec.zero_point


def quantize(x: torch.Tensor, spec: QuantSpec, scale) -> torch.Tensor:
    """Real values -> integer codes in ``[0, K)`` (uint8)."""
    q = _pre_clip(x, spec, scale)
    return torch.clamp(q, 0, spec.cardinality - 1).to(spec.storage_dtype)


def quantize_with_stats(x: torch.Tensor, spec: QuantSpec, scale):
    """:func:`quantize` plus its saturation statistics: ``(codes, count,
    ratio)`` with ``count`` the int32 number of elements whose pre-clip code
    left ``[0, K)`` and ``ratio`` the float32 ``max(|x|) / scale`` (scale
    taken in ``x``'s dtype).  The host oracle of every counter kernel."""
    q = _pre_clip(x, spec, scale)
    sat = (q < 0) | (q > spec.cardinality - 1)
    codes = torch.clamp(q, 0, spec.cardinality - 1).to(spec.storage_dtype)
    count = sat.sum(dtype=torch.int32)
    s = _scale_like(scale, x).to(x.dtype)
    ratio = (x.abs().max() / s).to(torch.float32)
    return codes, count, ratio


def dequantize(codes: torch.Tensor, spec: QuantSpec, scale,
               dtype=torch.float32) -> torch.Tensor:
    """Integer codes -> real values on the quantization grid."""
    s = torch.as_tensor(scale, dtype=dtype, device=codes.device)
    return (codes.to(dtype) - spec.zero_point) * s


def code_values(spec: QuantSpec, scale, dtype=torch.float32, *,
                device=None) -> torch.Tensor:
    """The ``K`` real values the grid represents, indexed by code."""
    if device is None:
        device = scale.device if torch.is_tensor(scale) else "cpu"
    codes = torch.arange(spec.cardinality, dtype=torch.int32, device=device)
    return dequantize(codes, spec, scale, dtype)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through gradient inside the
    clip range backward."""

    @staticmethod
    def forward(ctx, x, spec, scale):
        s = _scale_like(scale, x)
        ctx.save_for_backward(x, s)
        ctx.spec = spec
        return dequantize(quantize(x, spec, s), spec, s, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        spec = ctx.spec
        lo = (0 - spec.zero_point) * s
        hi = (spec.cardinality - 1 - spec.zero_point) * s
        mask = ((x >= lo) & (x <= hi)).to(g.dtype)
        return g * mask, None, None


def fake_quant(x: torch.Tensor, spec: QuantSpec, scale) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT, the
    dense oracle of every table fetch)."""
    return _FakeQuant.apply(x, spec, scale)
