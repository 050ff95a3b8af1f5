"""Synthetic training data, bit for bit ``repro``'s."""

from repro_torch.data.pipeline import (
    DataConfig,
    ShardedLoader,
    SyntheticLM,
    to_torch,
)

__all__ = ["DataConfig", "SyntheticLM", "ShardedLoader", "to_torch"]
