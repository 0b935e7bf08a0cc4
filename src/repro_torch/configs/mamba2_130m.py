"""mamba2-130m [ssm] — 24L d768 attention-free, vocab 50280, SSD with
d_state 128, head_dim 64 (24 heads), expand 2, conv kernel 4, tied embeds.
[arXiv:2405.21060; the same shape as repro.configs.mamba2_130m]"""

from .base import ModelConfig, SSMConfig


def config():
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280, head_dim=1,
        ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, conv_kernel=4,
                      expand=2, chunk=256),
        tie_embeddings=True,
        remat_policy="full", loss_chunk=1024,
    )


def smoke_config():
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256, head_dim=1,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, conv_kernel=4,
                      expand=2, chunk=16),
        tie_embeddings=True,
        remat_policy="none", loss_chunk=0,
    )
