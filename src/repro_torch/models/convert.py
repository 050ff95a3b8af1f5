"""Parameter conversion from the JAX package's layout.

``repro`` and this package keep the same parameter tree (nested dicts,
per-layer weights stacked on a leading axis), so conversion is a copy of
every leaf into a tensor.  The caller hands the JAX parameters over as
numpy arrays (``jax.tree.map(np.asarray, params)``); this module itself
never imports JAX.  :func:`train_state_to_numpy` goes the other way for a
train state, so it can be held against ``repro``'s.
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


def to_numpy(tree):
    """A numpy copy of a nested dict of tensors (bf16 as float32); None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_to_numpy(state) -> dict:
    """A ``train.step.TrainState`` as numpy, laid out as ``repro``'s
    ``TrainState`` converts with ``jax.tree.map(np.asarray, ...)``:
    ``params``, ``opt`` (``step``, ``mu``, ``nu``), ``step`` and ``err``
    (the int8 error feedback, or None)."""
    return {"params": to_numpy(state.params),
            "opt": {"step": to_numpy(state.opt.step),
                    "mu": to_numpy(state.opt.mu),
                    "nu": to_numpy(state.opt.nu)},
            "step": to_numpy(state.step),
            "err": to_numpy(state.err)}


__all__ = ["from_jax_params", "to_numpy", "train_state_to_numpy"]
