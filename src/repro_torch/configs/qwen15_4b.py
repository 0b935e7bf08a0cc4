"""qwen1.5-4b [dense] — 40L d2560 20H (MHA kv=20) d_ff 6912, vocab 151936,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; the same shape as repro.configs.qwen15_4b]

Heads (q and kv) pad 20->32, as the reference pads them for 16-way tensor
parallelism; head ``h`` reads KV head ``h // rep`` over the padded counts.
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab=151936, head_dim=128,
        qkv_bias=True, pad_heads_to=32, pad_kv_heads_to=32,
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="qwen15-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16, qkv_bias=True,
        remat_policy="none", loss_chunk=0,
    )
