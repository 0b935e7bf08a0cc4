"""repro_torch.data — the seeded synthetic LM corpus with its modality
stubs."""

from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
