"""Feed-forward blocks: gated (SwiGLU/GeGLU) and classic 2-matrix MLP."""

from __future__ import annotations

import torch

from repro_torch.layers.common import act_fn, constrain, dense_init


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, device=None) -> dict:
    p = {"wi": dense_init(gen, d_model, d_ff, device=device),
         "wo": dense_init(gen, d_ff, d_model, device=device)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, device=device)
    return p


def mlp(params: dict, x: torch.Tensor, *, act: str = "silu", dp=None,
        tag: str = "mlp") -> torch.Tensor:
    h = torch.matmul(x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.matmul(x, params["wg"].to(x.dtype))
        h = act_fn(act)(g) * h
    else:
        h = act_fn(act)(h)
    h = constrain(dp, h, ("batch", "seq", "mlp"), tag=f"{tag}/hidden")
    out = torch.matmul(h, params["wo"].to(x.dtype))
    return constrain(dp, out, ("batch", "seq", "embed"), tag=f"{tag}/out")


__all__ = ["mlp_init", "mlp"]
