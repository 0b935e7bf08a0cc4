"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) d_ff 8192,
vocab 202048, MoE 128 experts top-1 + always-on shared expert, MoE every
other layer (interleave 2: the public Maverick alternates dense/MoE).
[hf:meta-llama/Llama-4-Scout-17B-16E; the same shape as
repro.configs.llama4_maverick_400b_a17b]

Heads pad 40->48; the 128 experts need no padding.  One card cannot hold
its full width (one MoE layer's experts are 64.4 GB in float32).
"""

from .base import ModelConfig, MoEConfig


def config():
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128,
        pad_heads_to=48,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                      interleave=2, shared_expert=True),
        rope_theta=500000.0,
        remat_policy="full", loss_chunk=512, grad_accum=4,
    )


def smoke_config():
    return ModelConfig(
        name="llama4-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128,
                      interleave=2, shared_expert=True),
        remat_policy="none", loss_chunk=0,
    )
