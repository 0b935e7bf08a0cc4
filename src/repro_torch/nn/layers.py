"""Base layers (port of the dense / embedding / RMSNorm part of
``repro.nn.layers``): pure functions ``f(params, x) -> y`` over parameter
dicts built from :mod:`repro_torch.nn.module` specs."""

from __future__ import annotations

import torch

from .module import ParamSpec

__all__ = ["dense_spec", "dense", "embed_spec", "embed", "rmsnorm_spec",
           "rmsnorm"]


def dense_spec(d_in: int, d_out: int, dtype=torch.float32,
               init: str = "fan_in"):
    return {"kernel": ParamSpec((d_in, d_out), dtype, init)}


def dense(params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [..., d_in] @ kernel [d_in, d_out]`` in ``compute_dtype``."""
    return x.to(compute_dtype) @ params["kernel"].to(compute_dtype)


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
