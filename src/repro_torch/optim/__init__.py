"""repro_torch.optim — AdamW (with int8 moments), its state's specs,
schedules and clipping, and the compressed gradient reduction over a mesh
axis (``compress``: int8, bfloat16 or float32 on the single-process mesh,
as the reference's ``compressed_pmean``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_init_specs, adamw_update,
                    cosine_schedule, global_norm, clip_by_global_norm)
from .compress import compress_grads_tree, compressed_pmean

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_specs", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "compressed_pmean", "compress_grads_tree"]
