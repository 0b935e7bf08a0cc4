"""deepseek-coder-33b [dense] — 62L d7168 56H (GQA kv=8) d_ff 19200,
vocab 32256, llama architecture, rope theta 1e5.  [arXiv:2401.14196; the
same shape as repro.configs.deepseek_coder_33b]

Query heads pad 56->64, as the reference pads them for 16-way tensor
parallelism.
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab=32256, head_dim=128,
        pad_heads_to=64,
        rope_theta=100000.0,
        remat_policy="full", loss_chunk=2048,
    )


def smoke_config():
    return ModelConfig(
        name="deepseek-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=256, head_dim=8,
        remat_policy="none", loss_chunk=0,
    )
