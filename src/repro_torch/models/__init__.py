"""repro_torch.models — the ported model families (dense transformers and
Mamba2 so far) and the paper's CNN."""

from .cnn import PaperCNN
from .mamba import MambaLM
from .transformer import TransformerLM

__all__ = ["MambaLM", "PaperCNN", "TransformerLM", "build_model"]


def build_model(cfg):
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "dense":
        return TransformerLM(cfg)
    raise ValueError(f"family {cfg.family!r} is not ported yet (dense and "
                     f"ssm are)")
