"""repro_torch.optim — AdamW (with int8 moments), its state's specs,
schedules and clipping (the reference's ``optim`` without its compressed
gradient collectives, which wait for the multi-process mesh)."""

from .adamw import (AdamWConfig, adamw_init, adamw_init_specs, adamw_update,
                    cosine_schedule, global_norm, clip_by_global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_specs", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]
