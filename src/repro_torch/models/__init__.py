"""repro_torch.models — the model families (dense and MoE transformers,
whisper's encoder-decoder, llava's image-token fusion, Mamba2, the
Zamba2-style hybrid) and the paper's CNN."""

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
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return TransformerLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
