"""Mamba (S6) selective-state-space block.

The recurrence  h_t = Ā_t ⊙ h_{t-1} + B̄_t x_t,  y_t = C_t·h_t + D x_t
runs in ``kernels/ssm_scan``: the Hopper kernel on a CUDA tensor, its
plain time loop on the CPU.  The discretization exp(dt·A) is computed
inside the scan, so the (B, S, d_inner, N) dA tensor never exists in
device memory.  With gradients wanted the scan is ``ops.SSMScan``, whose
backward recomputes the states a chunk at a time, so training never
holds that tensor either.

Decode keeps (conv_tail, h) as recurrent cache: O(1) per token.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan.ops import SSMScan, ssm_scan, ssm_scan_plain
from repro_torch.layers.common import constrain, dense_init
from repro_torch.layers.kvcache import state_slot_insert


def mamba_init(gen: torch.Generator, d_model: int, cfg: SSMConfig,
               device=None) -> dict:
    """Random parameters from ``gen`` in ``repro``'s layout."""
    di = cfg.expand * d_model
    dt_rank = cfg.dt_rank or max(1, math.ceil(d_model / 16))
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialization for A
    a = torch.arange(1, cfg.state_size + 1, **f32)[None, :].repeat(di, 1)
    u = torch.rand((di,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    in_proj = dense_init(gen, d_model, 2 * di, device=device)
    conv = torch.randn((cfg.conv_width, di), generator=gen, **f32) \
        / math.sqrt(cfg.conv_width)
    return {
        "in_proj": in_proj,
        "conv": conv,
        "conv_bias": torch.zeros((di,), **f32),
        "x_proj": dense_init(gen, di, dt_rank + 2 * cfg.state_size,
                             device=device),
        "dt_proj": dense_init(gen, dt_rank, di, scale=dt_rank ** -0.5,
                              device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(a),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, di, d_model, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,di), w: (W,di). Returns (out,
    new_tail) where tail is the last (W-1) inputs for streaming decode."""
    wlen = w.shape[0]
    s = x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], wlen - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, wlen):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    new_tail = xp[:, -(wlen - 1):] if wlen > 1 else tail
    return out + bias.to(x.dtype), new_tail


def ssm_scan_chunked(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     bc: torch.Tensor, cc: torch.Tensor, h0: torch.Tensor, *,
                     chunk: int = 128, impl: str = "flash"):
    """Evaluate the diagonal SSM recurrence.

    dt/x: (B,S,di); a: (di,N); bc/cc: (B,S,N); h0: (B,di,N).
    Returns y: (B,S,di), h_final: (B,di,N).  ``repro``'s signature; the
    scan is ``kernels.ssm_scan.ops.ssm_scan`` with ``chunk`` time steps
    staged at once, or its plain version with ``impl="plain"``.  When an
    input wants a gradient it is ``ops.SSMScan``."""
    if impl not in ("flash", "plain"):
        raise ValueError(f"unknown scan impl {impl!r}")
    args = tuple(t.contiguous() for t in (dt, x, a, bc, cc, h0))
    plain = impl == "plain"
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSMScan.apply(*args, plain)
    if plain:
        return ssm_scan_plain(*args)
    return ssm_scan(*args, chunk=chunk)


def mamba(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
          state: dict | None = None, dp=None, chunk: int = 128,
          impl: str = "flash"):
    """Mamba block. x: (B,S,D). ``state`` (decode): {"conv": tail, "h": h}.
    ``impl="plain"`` takes the scan's plain version (any device).

    Returns (out, new_state)."""
    b, s, d = x.shape
    di = cfg.expand * d
    n = cfg.state_size

    xz = torch.einsum("bsd,de->bse", x, params["in_proj"].to(x.dtype))
    xi, z = torch.split(xz, di, dim=-1)
    # a split is a strided view; the dataplane kernel moves whole tensors
    xi = constrain(dp, xi.contiguous(), ("batch", "seq", "mlp"),
                   tag="mamba/inner")

    tail = state["conv"].to(xi.dtype) if state is not None else None
    xi, new_tail = _causal_conv(xi, params["conv"], params["conv_bias"], tail)
    xi = F.silu(xi)

    proj = torch.einsum("bse,ef->bsf", xi, params["x_proj"].to(x.dtype))
    dt_rank = params["dt_proj"].shape[0]
    dt_low, Bc, Cc = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(
        torch.einsum("bsr,re->bse", dt_low, params["dt_proj"].to(x.dtype))
        .float() + params["dt_bias"])                          # (B,S,di)
    # bf16 parameters (the dry run's serve cells) promote to float32 as
    # jnp's arithmetic does
    A = (-torch.exp(params["A_log"])).float()                  # (di,N)

    h0 = (state["h"] if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    y, h_final = ssm_scan_chunked(dt, xi.float(), A, Bc.float(), Cc.float(),
                                  h0, chunk=chunk, impl=impl)
    y = y.to(x.dtype) + params["D"].to(x.dtype) * xi
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(x.dtype))
    out = constrain(dp, out, ("batch", "seq", "embed"), tag="mamba/out")
    new_state = {"conv": new_tail.float(), "h": h_final}
    return out, new_state


def mamba_state_init(batch: int, d_model: int, cfg: SSMConfig, dtype,
                     device=None) -> dict:
    di = cfg.expand * d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, cfg.state_size), dtype=torch.float32,
                             device=device)}


def mamba_state_slot_insert(state: dict, prefilled: dict, slot: int) -> dict:
    """Write one prefilled request's mamba decode state (batch row 0 of a
    batch-1 ``{"conv", "h"}`` dict) into slot ``slot`` of a persistent
    multi-slot state, in place.  ``conv`` and ``h`` are O(1) summaries, so
    the insert replaces the slot's state wholesale; once the model stacks
    a layer axis in front (models/hybrid.py) the engine uses
    ``state_slot_insert`` on the whole cache instead."""
    return state_slot_insert(state, prefilled, slot, batch_axis=0)


__all__ = ["mamba_init", "mamba", "mamba_state_init",
           "mamba_state_slot_insert", "ssm_scan_chunked"]
