"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) d_ff 512/expert,
vocab 49155, MoE 40 experts top-8, MoE every layer.
[hf:ibm-granite/granite-3.0-1b-a400m-base; the same shape as
repro.configs.granite_moe_3b_a800m]

Heads pad 24->32 and experts 40->48 (dead experts are router-masked);
vocab pads 49155->49168.
"""

from .base import ModelConfig, MoEConfig


def config():
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        pad_heads_to=32,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                      interleave=1, pad_experts_to=48),
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="granite-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, head_dim=16,
        moe=MoEConfig(n_experts=10, top_k=4, d_ff_expert=32, interleave=1,
                      pad_experts_to=12),
        remat_policy="none", loss_chunk=0,
    )
