"""llava-next-mistral-7b [vlm] — the Mistral-7B backbone: 32 layers, d
4096, 32 heads over 8 KV heads, d_ff 14336, vocab 32000, a sliding window
of 4096 (a rolling KV buffer at decode).  The vision frontend is a stub:
the data supplies 576 patch embeddings, projected and placed before the
text (early fusion).  [hf:llava-hf/llava-v1.6-mistral-7b-hf; the same
shape as repro.configs.llava_next_mistral_7b]
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        window=4096, n_img_tokens=576,
        rope_theta=1000000.0,
        remat_policy="full", loss_chunk=2048,
    )


def smoke_config():
    return ModelConfig(
        name="llava-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        window=32, n_img_tokens=8,
        remat_policy="none", loss_chunk=0,
    )
