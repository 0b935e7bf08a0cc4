"""repro_torch.models — the ported model families (Mamba2 so far) and the
paper's CNN."""

from .cnn import PaperCNN
from .mamba import MambaLM

__all__ = ["MambaLM", "PaperCNN", "build_model"]


def build_model(cfg):
    if cfg.family != "ssm":
        raise ValueError(f"family {cfg.family!r} is not ported yet (ssm is)")
    return MambaLM(cfg)
