"""The activation grid of PCILT, written out plainly: ``K = 2**bits`` codes,
zero point ``K/2`` on a symmetric grid and 0 on an asymmetric one, codes
``clip(round_half_even(x / scale) + zero_point, 0, K - 1)`` with a true
float32 division, values ``(code - zero_point) * scale``."""

from __future__ import annotations

import torch


def span(bits: int, symmetric: bool) -> int:
    """The codes above the zero point (below it one more on a symmetric
    grid)."""
    k = 1 << bits
    return max(k - 1 - k // 2, 1) if symmetric else k - 1


def scale_from_amax(amax, bits: int, symmetric: bool) -> torch.Tensor:
    """A float32 scale that maps ``amax`` onto the grid's top code."""
    a = torch.as_tensor(amax, dtype=torch.float32)
    return torch.clamp_min(a, 1e-8) / span(bits, symmetric)


def fake_quant(x: torch.Tensor, bits: int, symmetric: bool,
               scale) -> torch.Tensor:
    """Quantize then dequantize ``x`` (float32) on the grid."""
    k = 1 << bits
    zp = k // 2 if symmetric else 0
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.float() / s) + zp, 0, k - 1)
    return (q - zp) * s


class tf32:
    """``with tf32(torch):`` TF32 in matmuls and convolutions inside the
    block: the control's precision, the step below float32."""

    def __init__(self, torch):
        self.b = torch.backends

    def __enter__(self):
        self.saved = (self.b.cuda.matmul.allow_tf32, self.b.cudnn.allow_tf32)
        self.b.cuda.matmul.allow_tf32 = self.b.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        self.b.cuda.matmul.allow_tf32, self.b.cudnn.allow_tf32 = self.saved
        return False
