"""qwen3-0.6b [dense] — 28L d1024 16H (GQA kv=8) d_ff 3072, vocab 151936,
qk-norm, head_dim 128 (decoupled from d_model/H), tied embeddings, rope
theta 1e6.  [hf:Qwen/Qwen3-8B; the same shape as repro.configs.qwen3_06b]
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, tie_embeddings=True,
        rope_theta=1000000.0,
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=32, qk_norm=True, tie_embeddings=True,
        remat_policy="none", loss_chunk=0,
    )
