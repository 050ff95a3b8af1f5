"""Optimizers of the port (AdamW)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "warmup_cosine"]
