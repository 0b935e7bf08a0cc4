"""qwen2.5-3b [dense] — 36L d2048 16H (GQA kv=2) d_ff 11008, vocab 151936,
QKV bias, tied embeddings.  [hf:Qwen/Qwen2.5-0.5B; the same shape as
repro.configs.qwen25_3b]
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936, head_dim=128,
        qkv_bias=True, tie_embeddings=True,
        rope_theta=1000000.0,
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="qwen25-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, qkv_bias=True, tie_embeddings=True,
        remat_policy="none", loss_chunk=0,
    )
