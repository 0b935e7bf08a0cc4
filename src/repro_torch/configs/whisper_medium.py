"""whisper-medium [audio] — encoder-decoder, 24 + 24 layers, d 1024, 16
heads (MHA), d_ff 4096, vocab 51865, LayerNorm and GELU, sinusoidal
positions.  The conv frontend is a stub: the data supplies 1500 frame
embeddings (30 s of audio).  [arXiv:2212.04356; the same shape as
repro.configs.whisper_medium]
"""

from .base import ModelConfig


def config():
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        encoder_layers=24, encoder_len=1500,
        pos_embed="sinusoidal",
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        encoder_layers=2, encoder_len=16,
        pos_embed="sinusoidal",
        remat_policy="none", loss_chunk=0,
    )
