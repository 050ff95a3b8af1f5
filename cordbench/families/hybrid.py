"""The hybrid family (hymba): every layer runs GQA attention and a mamba
(S6) branch side by side on the same normed input, then a gated MLP."""

from __future__ import annotations

import math

import torch

from cordbench import flops, weights
from cordbench.reference import hybrid_lm
from cordbench.reference.common import (Precision, layer, layer_windows,
                                        rmsnorm)

loss = hybrid_lm.loss
attention_windows = layer_windows


def layout(cfg) -> list:
    d, L = cfg.d_model, cfg.num_layers
    return weights.transformer_leaves(
        cfg, weights.mlp_leaves(cfg)
        + [(("attn_norm", "scale"), (L, d), "norm", 0.1),
           (("mamba_norm", "scale"), (L, d), "norm", 0.1)]
        + weights.mamba_leaves(cfg))


def matmul_params(m: dict) -> int:
    return m["num_layers"] * (flops.attention_params(m) + flops.mlp_params(m)
                              + flops.mamba_params(m))


def request_flops(m: dict, prompt: int, new: int) -> int:
    """Serving FLOPs, the scan's forward in every layer counted as
    training counts it."""
    return flops.serve_flops(m, prompt, new, matmul_params(m),
                             attention_windows(m),
                             scan_layers=m["num_layers"])


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    return flops.train_flops(m, batch, seq, matmul_params(m),
                             attention_windows(m),
                             scan_layers=m["num_layers"])


@torch.no_grad()
def logits_at(params: dict, mcfg: dict, tokens: torch.Tensor,
              positions: torch.Tensor, prec: Precision | None = None,
              margins: list | None = None):
    """float32 logits (len(positions), V) of the whole-sequence forward of
    ``tokens`` (S,) from position 0 through `hybrid_lm.block`, the mamba
    branch from a zero state, read at ``positions``.  ``margins`` is
    `moe_lm.logits_at`'s and stays empty: no layer routes."""
    prec = prec or Precision()
    tab = params["embed"]["tok"]
    x = (tab[tokens].float() * math.sqrt(mcfg["d_model"]))[None]
    for i, window in enumerate(layer_windows(mcfg)):
        x = hybrid_lm.block(x, layer(params["layers"], i), mcfg, window, prec)
    x = rmsnorm(x, params["final_norm"]["scale"], mcfg["norm_eps"])
    return prec.mm(x[0, positions], tab.t())
