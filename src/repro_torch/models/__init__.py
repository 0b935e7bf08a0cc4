"""repro_torch.models — the ported model families (dense and MoE
transformers, Mamba2, the Zamba2-style hybrid) and the paper's CNN."""

from .cnn import PaperCNN
from .hybrid import HybridLM
from .mamba import MambaLM
from .transformer import TransformerLM

__all__ = ["HybridLM", "MambaLM", "PaperCNN", "TransformerLM", "build_model"]


def build_model(cfg):
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg)
    raise ValueError(f"family {cfg.family!r} is not ported yet (dense, moe, "
                     f"ssm and hybrid are)")
