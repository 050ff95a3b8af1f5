"""Sharding rules: logical axis names to mesh axes, and partition specs
of parameters, caches and batches."""

from repro_torch.parallel.sharding import (
    DATA,
    MODEL,
    POD,
    P,
    PartitionSpec,
    activation_rules,
    batch_specs,
    cache_spec_tree,
    filter_spec,
    param_specs,
    spec_for_param,
)

__all__ = [
    "DATA", "MODEL", "POD", "P", "PartitionSpec", "activation_rules",
    "batch_specs", "cache_spec_tree", "filter_spec", "param_specs",
    "spec_for_param",
]
