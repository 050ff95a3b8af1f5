"""Checkpoints in ``repro``'s on-disk format."""

from repro_torch.checkpoint.store import all_steps, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "all_steps"]
