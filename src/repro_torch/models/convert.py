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
    _check_family(out, cfg)
    return out


def _check_family(params: dict, cfg: ModelConfig) -> None:
    """The family's own leaves are there with ``cfg``'s shapes: the
    stacked layers' norm (an xlstm tree's per-block units), a moe tree's
    router and experts, a vlm tree's ``vision_proj``, an encdec tree's
    frontend and encoder layers."""
    n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        pat = cfg.ssm.block_pattern
        if n % len(pat):
            pat = (pat * n)[:n]
        want = {("units", f"blk{j}", "norm", "scale"): (n // len(pat), d)
                for j in range(len(pat))}
    else:
        want = {("layers", "norm1", "scale"): (n, d)}
    if cfg.family == "moe":
        e = cfg.moe.num_experts
        want.update({("layers", "moe", "router"): (n, d, e),
                     ("layers", "moe", "wi"): (n, e, d, f),
                     ("layers", "moe", "wo"): (n, e, f, d)})
        if cfg.gated_mlp:
            want[("layers", "moe", "wg")] = (n, e, d, f)
        if cfg.moe.dense_residual:
            want[("layers", "moe", "dense", "wi")] = \
                (n, d, cfg.moe.dense_residual_ff)
    elif cfg.family == "vlm":
        want[("vision_proj",)] = (cfg.frontend_dim, d)
    elif cfg.family == "encdec":
        want[("frontend",)] = (cfg.frontend_dim, d)
        want[("enc_layers", "norm1", "scale")] = (cfg.encoder_layers, d)
    for path, shape in want.items():
        node = params
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        name = "/".join(path)
        if node is None:
            raise ValueError(f"parameters do not match {cfg.name}: the "
                             f"{cfg.family} tree has no {name}")
        if tuple(node.shape) != shape:
            raise ValueError(f"parameters do not match {cfg.name}: {name} "
                             f"{tuple(node.shape)}, want {shape}")


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
