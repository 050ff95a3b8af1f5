"""The moe family (grok-1): pre-norm blocks of GQA attention with a tanh
soft cap and a top-k mixture of GeGLU experts in every layer."""

from __future__ import annotations

from cordbench import flops, weights
from cordbench.reference import moe_lm
from cordbench.reference.common import layer_windows

logits_at = moe_lm.logits_at
attention_windows = layer_windows


def layout(cfg) -> list:
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    e = cfg.moe.num_experts
    return weights.transformer_leaves(cfg, [
        (("moe", "router"), (L, d, e), "normal", 1e-2),
        (("moe", "wi"), (L, e, d, f), "normal", d ** -0.5),
        (("moe", "wg"), (L, e, d, f), "normal", d ** -0.5),
        (("moe", "wo"), (L, e, f, d), "normal", f ** -0.5)])


def matmul_params(m: dict) -> int:
    """Weights one token multiplies through every layer: attention
    projections, the router and its top-k experts."""
    return m["num_layers"] * (flops.attention_params(m)
                              + m["d_model"] * m["moe"]["num_experts"]
                              + flops.mlp_params(m) * m["moe"]["top_k"])


def request_flops(m: dict, prompt: int, new: int) -> int:
    return flops.serve_flops(m, prompt, new, matmul_params(m),
                             attention_windows(m))
