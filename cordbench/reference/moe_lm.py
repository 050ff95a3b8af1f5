"""Plain reference of the moe transformer the grok cells serve: pre-norm
blocks of causal GQA attention with a tanh soft cap and a top-k mixture
of GeGLU experts, tied embeddings, float32 logits.

Each token goes to its own top-k experts (the dropless routing the
program serves with); nothing is batched or cached.
"""

from __future__ import annotations

import math

import torch

from cordbench.reference.common import (Precision, attention, gelu_tanh,
                                        layer, layer_windows, rmsnorm)


def moe(h: torch.Tensor, p: dict, top_k: int, prec: Precision,
        margins: list | None = None):
    """(T, D) tokens through the router and their top-k experts: softmax
    over all experts, the k largest (ties to the lower index), gates
    renormalised to sum 1, GeGLU with the gelu on the gate branch.  With
    ``margins``, each token's gap between the k-th and the next expert's
    probability is appended (how near its routing is to a tie)."""
    probs = torch.softmax(prec.mm(h, p["router"]), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append(gates[:, top_k - 1] - gates[:, top_k])
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(p["router"].shape[-1]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if not rows.numel():
            continue
        xe = h[rows]
        y = prec.mm(gelu_tanh(prec.mm(xe, p["wg"][e])) * prec.mm(xe, p["wi"][e]),
                    p["wo"][e])
        out.index_add_(0, rows, gates[rows, slot][:, None] * y)
    return out


@torch.no_grad()
def logits_at(params: dict, mcfg: dict, tokens: torch.Tensor,
              positions: torch.Tensor, prec: Precision | None = None,
              margins: list | None = None):
    """float32 logits (len(positions), V) of the whole-sequence forward of
    ``tokens`` (S,) from position 0, read at ``positions``; ``margins``
    collects each layer's routing margins (see :func:`moe`)."""
    prec = prec or Precision()
    a = mcfg["attention"]
    d = mcfg["d_model"]
    tab = params["embed"]["tok"]
    x = (tab[tokens].float() * math.sqrt(d))[None]
    for i, window in enumerate(layer_windows(mcfg)):
        lp = layer(params["layers"], i)
        h = rmsnorm(x, lp["norm1"]["scale"], mcfg["norm_eps"])
        x = x + attention(h, lp["attn"], heads=a["num_heads"],
                          kv_heads=a["num_kv_heads"], theta=a["rope_theta"],
                          window=window, cap=a["logit_softcap"], prec=prec)
        h = rmsnorm(x, lp["norm2"]["scale"], mcfg["norm_eps"])
        x = x + moe(h[0], lp["moe"], mcfg["moe"]["top_k"], prec,
                    margins)[None]
    x = rmsnorm(x, params["final_norm"]["scale"], mcfg["norm_eps"])
    return prec.mm(x[0, positions], tab.t())
