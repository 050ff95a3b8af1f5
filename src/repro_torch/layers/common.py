"""Shared layer primitives: norms, activations, initializers.

All layers are plain functions over dicts of tensors, with per-layer
weights stacked on a leading layer axis as in ``repro``.  Every function
takes an optional ``dp`` (Dataplane) used to issue logical sharding
edges through the paper's mediation layer; ``dp=None`` means local
execution.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def constrain(dp, x: torch.Tensor, names: Sequence, tag: str = "act",
              qos: str = "default") -> torch.Tensor:
    """Issue a sharding edge through the dataplane's mediation pipeline."""
    if dp is None:
        return x
    return dp.constrain(x, names, tag=tag, qos=qos)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# initializers (torch.Generator; the JAX package's numbers differ, so the
# tests hand JAX's parameters over with models/convert.py)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, *out_dims: int,
               device=None, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init for a (in_dim, *out_dims) kernel."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return _trunc_normal((in_dim, *out_dims), gen, device).mul_(std)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               device=None) -> torch.Tensor:
    return _trunc_normal((vocab, dim), gen, device) / math.sqrt(dim)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, device=None) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale): zero-init scale = identity at init
    return (x * (1.0 + params["scale"])).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


__all__ = [
    "constrain", "act_fn", "dense_init", "embed_init", "rmsnorm_init",
    "rmsnorm", "softcap", "dtype_of",
]
