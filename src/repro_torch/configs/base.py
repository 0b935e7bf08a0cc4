"""Config dataclasses (port of ``repro.configs.base``): the model
configs and the shapes the dry run sizes them at.

The fields mirror the reference's, in its order as far as ``pos_embed``
(a positional config binds the same fields in both packages); the rest are
keyword-only, in the reference's order.  Dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "PCILTConfig",
           "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    interleave: int = 1          # MoE every `interleave` layers (2 = alternate)
    shared_expert: bool = False  # always-on shared expert (llama4)
    capacity_factor: float = 1.25
    pad_experts_to: int = 0      # 0 = no padding

    @property
    def padded_experts(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


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
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 0              # sliding-window size (0 = full attention)
    rope_theta: float = 10000.0
    pos_embed: str = "rope"      # rope | sinusoidal | none
    # every field from here on is keyword-only (in the reference's order)
    _: dataclasses.KW_ONLY
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0  # zamba2: shared attention every N blocks
    n_shared_attn_blocks: int = 2
    encoder_layers: int = 0      # whisper: encoder blocks (0: decoder-only)
    encoder_len: int = 1500      # whisper: encoder frames
    n_img_tokens: int = 0        # llava: image tokens placed before the text
    # head-count padding, part of the config so parameter shapes do not
    # depend on a mesh
    pad_heads_to: int = 0
    pad_kv_heads_to: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat_policy: str = "dots"   # none | dots | full (training only)
    loss_chunk: int = 2048       # vocab-loss token chunking (0 = unchunked)
    grad_accum: int = 1          # microbatches per train step
    pcilt: Optional[PCILTConfig] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def padded_kv_heads(self) -> int:
        return max(self.n_kv_heads, self.pad_kv_heads_to)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Decode memory that does not grow with the context: a state
        space model, or a sliding window."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 16 (padded ids are never
        produced by data or sampling)."""
        return self.vocab + (-self.vocab) % 16


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape: a ``[global_batch, seq_len]`` token grid to train
    or prefill on, or a decode step against a KV cache of ``seq_len``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
