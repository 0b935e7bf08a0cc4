"""Config dataclasses (port of the Mamba part of ``repro.configs.base``).

The fields mirror the reference's; dtypes are torch dtypes.  Only what the
Mamba2 decode path reads is carried over so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ModelConfig", "SSMConfig", "PCILTConfig"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class PCILTConfig:
    """Paper-technique integration for quantized serving."""

    act_bits: int = 4
    group: int = 2
    weight_bits: int = 4
    apply_to_conv: bool = True   # frontends
    apply_to_gemv: bool = True   # decode projections


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # ssm (the only family ported so far)
    n_layers: int
    d_model: int
    vocab: int
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    pcilt: Optional[PCILTConfig] = None

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 16 (padded ids are never
        produced by data or sampling)."""
        return self.vocab + (-self.vocab) % 16
