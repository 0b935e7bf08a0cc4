"""repro_torch.checkpoint — async checkpoints on the reference's layout."""

from .checkpoint import save, save_async, restore, latest_step, Checkpointer

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer"]
