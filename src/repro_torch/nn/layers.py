"""Base layers (port of the dense, embedding, norm and position part of
``repro.nn.layers``): pure functions ``f(params, x) -> y`` over parameter
dicts built from :mod:`repro_torch.nn.module` specs."""

from __future__ import annotations

import torch

from .module import ParamSpec

__all__ = ["dense_spec", "dense", "embed_spec", "embed", "rmsnorm_spec",
           "rmsnorm", "layernorm_spec", "layernorm", "rope",
           "sinusoidal_positions"]


def dense_spec(d_in: int, d_out, *, bias: bool = False, dtype=torch.float32,
               init: str = "fan_in"):
    """Kernel ``[d_in, *d_out]`` (``d_out`` an int or a tuple), with a
    zero bias ``[*d_out]`` when ``bias``."""
    out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    p = {"kernel": ParamSpec((d_in, *out_shape), dtype, init)}
    if bias:
        p["bias"] = ParamSpec(out_shape, dtype, "zeros")
    return p


def dense(params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [..., d_in] @ kernel [d_in, *rest] -> [..., *rest]`` in
    ``compute_dtype`` (plus the bias, cast alike)."""
    k = params["kernel"].to(compute_dtype)
    y = x.to(compute_dtype) @ k.reshape(k.shape[0], -1)
    y = y.reshape(*x.shape[:-1], *k.shape[1:])
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def embed_spec(vocab: int, d: int, dtype=torch.float32):
    # 1/sqrt(d) init keeps tied logits ~unit variance at init
    return {"embedding": ParamSpec((vocab, d), dtype, "embed", d ** -0.5)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token ids ``[...]`` -> embeddings ``[..., d]``."""
    return params["embedding"].to(dtype)[tokens]


def rmsnorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), dtype, "ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), dtype, "ones"),
            "bias": ParamSpec((d,), dtype, "zeros")}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The float32 mean, then the mean of the squared deviations, then
    ``rsqrt``, scale and bias; the result in ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves: ``x [..., S, H, D]`` (D even),
    ``positions [..., S]``; angles in float32, the result in ``x.dtype``."""
    half = x.shape[-1] // 2
    # the float32 exponent, then the power rounded once to float32 (as the
    # reference's float32 pow gives it; torch's float32 pow is off by an ulp
    # at some exponents)
    expo = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(float(theta), expo.double()).float()
    ang = positions.float()[..., None] * freq  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_positions(length: int, d: int, offset=0, *,
                         device=None) -> torch.Tensor:
    """``[length, d]`` float32 position embeddings of positions ``offset``
    .. ``offset + length - 1``: ``[sin, cos]`` of ``pos * freq`` with ``freq
    = 10000 ** (-i / max(d // 2 - 1, 1))``."""
    pos = torch.arange(length, dtype=torch.float32, device=device) + offset
    half = d // 2
    # the float32 exponent, the power rounded once to float32 (as in rope)
    expo = -torch.arange(half, dtype=torch.float32, device=device) \
        / max(half - 1, 1)
    freq = torch.pow(10000.0, expo.double()).float()
    ang = pos[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
