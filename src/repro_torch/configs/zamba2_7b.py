"""zamba2-7b [hybrid] — 81 Mamba2 blocks d3584 (d_state 64) + shared
attention blocks (32H MHA on concat(hidden, embed) = 7168 wide, d_ff 14336
MLP) applied every 6 blocks, 2 alternating shared param sets, vocab 32000.
[arXiv:2411.15242; the same shape as repro.configs.zamba2_7b]
"""

from .base import ModelConfig, SSMConfig


def config():
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, head_dim=112,
        ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, conv_kernel=4,
                      expand=2, chunk=256),
        shared_attn_period=6, n_shared_attn_blocks=2,
        remat_policy="full", loss_chunk=2048,
    )


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=32,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, conv_kernel=4,
                      expand=2, chunk=16),
        shared_attn_period=3, n_shared_attn_blocks=2,
        remat_policy="none", loss_chunk=0,
    )
