"""Parameter conversion from the JAX package's layout.

``repro`` and this package keep the same parameter tree (nested dicts,
per-layer weights stacked on a leading axis), so conversion is a copy of
every leaf into a tensor.  The caller hands the JAX parameters over as
numpy arrays (``jax.tree.map(np.asarray, params)``); this module itself
never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def from_jax_params(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from a numpy copy of ``repro``'s parameter
    tree for ``cfg``; every leaf is copied onto ``device`` (default
    ``cuda``) with its dtype kept."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind not in "fiub":
            raise TypeError(f"parameter {path}: unsupported dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)

    out = conv(params_np, "")
    layers = out["layers"]["norm1"]["scale"]
    if layers.shape != (cfg.num_layers, cfg.d_model):
        raise ValueError(f"parameters do not match {cfg.name}: norm1 scale "
                         f"{tuple(layers.shape)}")
    return out


__all__ = ["from_jax_params"]
