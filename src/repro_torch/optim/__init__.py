"""repro_torch.optim — AdamW (with int8 moments), schedules and clipping
(the reference's ``optim`` without its compressed gradient collectives,
which wait for distribution)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    global_norm, clip_by_global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]
