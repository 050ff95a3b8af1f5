"""The dense family: pre-norm blocks of GQA attention and an MLP in every
layer.  No cell serves or trains it yet, so it has no reference here."""

from __future__ import annotations

from cordbench import flops, weights
from cordbench.reference.common import layer_windows

attention_windows = layer_windows


def layout(cfg) -> list:
    return weights.transformer_leaves(cfg, weights.mlp_leaves(cfg))


def matmul_params(m: dict) -> int:
    return m["num_layers"] * (flops.attention_params(m) + flops.mlp_params(m))


def request_flops(m: dict, prompt: int, new: int) -> int:
    return flops.serve_flops(m, prompt, new, matmul_params(m),
                             attention_windows(m))
