"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM
(scalar memory with recurrent mixing, inherently sequential).

mLSTM uses the stabilized chunkwise-parallel form (linear attention with
per-head exponential gating): within a chunk the decay matrix is built in
log space; across chunks a (C, n, m) state is carried.  Decode is O(1)
per token: one chunk of one step.

sLSTM has recurrent weights (h_{t-1} feeds the gates), so it runs as a
Python loop over time (``lax.scan`` in ``repro``), block-diagonal per
head.

The stabiliser follows ``repro`` op for op, so gradients do too:
``torch.amax`` and ``torch.maximum`` split the gradient at ties as
``jnp.max`` and ``jnp.maximum`` do (``torch.max(dim)`` would hand it all
to one index), masked log weights are ``-inf`` before ``exp``, and the
denominator's ``abs`` has ``sign(0) = 0`` in both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.layers.common import (
    constrain,
    dense_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.layers.kvcache import state_slot_insert
from repro_torch.layers.mamba import _causal_conv


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig,
               device=None) -> dict:
    """Random parameters from ``gen`` in ``repro``'s layout."""
    di = cfg.expand * d_model
    h = cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    up = dense_init(gen, d_model, 2 * di, device=device)
    conv = torch.randn((cfg.conv_width, di), generator=gen, **f32) \
        / math.sqrt(cfg.conv_width)
    return {
        "up": up,
        "conv": conv,
        "conv_bias": torch.zeros((di,), **f32),
        "wq": dense_init(gen, di, di, device=device),
        "wk": dense_init(gen, di, di, device=device),
        "wv": dense_init(gen, di, di, device=device),
        "wi": dense_init(gen, di, h, scale=1e-2, device=device),
        "bi": torch.zeros((h,), **f32),
        "wf": dense_init(gen, di, h, scale=1e-2, device=device),
        "bf": torch.linspace(3.0, 6.0, h, **f32),   # forget-gate bias (open)
        "out_norm": rmsnorm_init(di, device=device),
        "down": dense_init(gen, di, d_model, device=device),
    }


def mlstm_state_init(batch: int, d_model: int, cfg: SSMConfig,
                     device=None) -> dict:
    di = cfg.expand * d_model
    h = cfg.num_heads
    hd = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), **f32),
        "C": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.full((batch, h), -1e30, **f32),
    }


def _mlstm_chunk(q, k, v, log_i, log_f, state, eps=1e-6):
    """One chunk of the stabilized chunkwise mLSTM.

    q,k,v: (B,H,c,hd); log_i/log_f: (B,H,c); state: dict(C,n,m).
    Returns (y, new_state)."""
    c, hd = q.shape[2], q.shape[3]
    C0, n0, m0 = state["C"], state["n"], state["m"]

    Fc = torch.cumsum(log_f, dim=-1)                         # (B,H,c)
    # log weights for source position s at target t: F_t - F_s + log_i_s
    lw = Fc[..., :, None] - Fc[..., None, :] + log_i[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    lw = torch.where(causal, lw, torch.full_like(lw, -math.inf))
    inter_l = Fc + m0[..., None]                             # carry weight
    m_t = torch.maximum(torch.amax(lw, dim=-1), inter_l)     # stabilizer
    D = torch.exp(lw - m_t[..., None])                       # (B,H,t,s)
    w_inter = torch.exp(inter_l - m_t)                       # (B,H,t)

    scale = 1.0 / math.sqrt(hd)
    qk = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    intra = torch.einsum("bhts,bhsd->bhtd", qk * D, v)
    inter = torch.einsum("bhtd,bhde->bhte", q * scale, C0) \
        * w_inter[..., None]
    num = intra + inter

    n_t = (torch.einsum("bhts,bhsd->bhtd", D, k)
           + n0[..., None, :] * w_inter[..., None])          # (B,H,t,hd)
    denom = torch.abs(torch.einsum("bhtd,bhtd->bht", q * scale, n_t))
    denom = torch.maximum(denom, torch.exp(-m_t)) + eps
    y = num / denom[..., None]

    # carry to the next chunk (the state at position c)
    wc = torch.exp(Fc[..., -1:] - Fc + log_i - m_t[..., -1:])   # (B,H,s)
    decay = torch.exp(Fc[..., -1] + m0 - m_t[..., -1])
    C_new = (C0 * decay[..., None, None]
             + torch.einsum("bhs,bhsd,bhse->bhde", wc, k, v))
    n_new = n0 * decay[..., None] + torch.einsum("bhs,bhsd->bhd", wc, k)
    return y, {"C": C_new, "n": n_new, "m": m_t[..., -1],
               "conv": state["conv"]}


def mlstm(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
          state: dict | None = None, dp=None, chunk: int = 128):
    """mLSTM block. x: (B,S,D). Returns (out, new_state)."""
    b, s, d = x.shape
    di = cfg.expand * d
    h = cfg.num_heads
    hd = di // h

    xz = torch.einsum("bsd,de->bse", x, params["up"].to(x.dtype))
    xm, z = torch.split(xz, di, dim=-1)
    # a split is a strided view; the dataplane kernel moves whole tensors
    xm = constrain(dp, xm.contiguous(), ("batch", "seq", "mlp"),
                   tag="mlstm/inner")

    if state is None:
        state = mlstm_state_init(b, d, cfg, device=x.device)
    tail = state["conv"].to(xm.dtype)
    xc, new_tail = _causal_conv(xm, params["conv"], params["conv_bias"],
                                tail)
    xc = F.silu(xc)

    def heads(t):  # (B,S,di) -> (B,H,S,hd)
        return t.reshape(b, s, h, hd).transpose(1, 2)

    q = heads(torch.einsum("bse,ef->bsf", xc, params["wq"].to(x.dtype)))
    k = heads(torch.einsum("bse,ef->bsf", xc, params["wk"].to(x.dtype)))
    v = heads(torch.einsum("bse,ef->bsf", xm, params["wv"].to(x.dtype)))
    log_i = (torch.einsum("bse,eh->bsh", xc, params["wi"].to(x.dtype))
             .float() + params["bi"]).transpose(1, 2)
    log_f_raw = (torch.einsum("bse,eh->bsh", xc, params["wf"].to(x.dtype))
                 .float() + params["bf"]).transpose(1, 2)
    log_f = -F.softplus(-log_f_raw)                          # log sigmoid

    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    st = dict(state)
    ys = []
    for lo in range(0, s, ck):
        y, st = _mlstm_chunk(q[:, :, lo:lo + ck].float(),
                             k[:, :, lo:lo + ck].float(),
                             v[:, :, lo:lo + ck].float(),
                             log_i[..., lo:lo + ck], log_f[..., lo:lo + ck],
                             st)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=2)      # (B,H,S,hd)
    y = y.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    y = rmsnorm(params["out_norm"], y)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["down"].to(x.dtype))
    out = constrain(dp, out, ("batch", "seq", "embed"), tag="mlstm/out")
    st["conv"] = new_tail.float()
    return out, st


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig,
               device=None) -> dict:
    """Random parameters from ``gen`` in ``repro``'s layout.  As in
    ``repro`` (which draws both from one key), the FFN's ``wg`` starts
    equal to its ``wi``."""
    h = cfg.num_heads
    hd = d_model // h
    dff = int(d_model * 4 / 3)
    f32 = dict(dtype=torch.float32, device=device)
    w = dense_init(gen, d_model, 4 * d_model, device=device)    # i,f,z,o
    r = torch.randn((h, hd, 4 * hd), generator=gen, **f32) / math.sqrt(hd)
    wi = dense_init(gen, d_model, dff, device=device)
    return {
        "w": w,
        "r": r,
        "b": torch.cat([torch.zeros((d_model,), **f32),
                        torch.full((d_model,), 3.0, **f32),  # forget open
                        torch.zeros((2 * d_model,), **f32)]),
        "ffn": {"wi": wi, "wg": wi.clone(),
                "wo": dense_init(gen, dff, d_model, device=device)},
        "ffn_norm": rmsnorm_init(d_model, device=device),
    }


def slstm_state_init(batch: int, d_model: int, cfg: SSMConfig,
                     device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d_model), **f32),
            "c": torch.zeros((batch, d_model), **f32),
            "n": torch.ones((batch, d_model), **f32),
            "m": torch.zeros((batch, d_model), **f32)}


def slstm(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
          state: dict | None = None, dp=None):
    """sLSTM layer + gated FFN. x: (B,S,D). Returns (out, new_state)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    if state is None:
        state = slstm_state_init(b, d, cfg, device=x.device)

    wx = (torch.einsum("bsd,de->bse", x, params["w"].to(x.dtype)).float()
          + params["b"])                                     # (B,S,4d)
    R = params["r"].float()      # (H,hd,4hd); bf16 promotes as in jnp

    hh, c, n, m = state["h"], state["c"], state["n"], state["m"]
    ys = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", hh.reshape(b, h, hd),
                           R).reshape(b, 4 * d)
        gi, gf, gz, go = torch.split(wx[:, t] + rec, d, dim=-1)
        m_new = torch.maximum(gf + m, gi)
        i = torch.exp(gi - m_new)
        f = torch.exp(gf + m - m_new)
        c = f * c + i * torch.tanh(gz)
        n = f * n + i
        hh = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(hh)
    y = torch.stack(ys, dim=1).to(x.dtype)                   # (B,S,D)

    # gated FFN sub-block (proj factor 4/3)
    yn = rmsnorm(params["ffn_norm"], y)
    fp = params["ffn"]
    hdn = _gelu(torch.einsum("bsd,df->bsf", yn, fp["wg"].to(x.dtype))) \
        * torch.einsum("bsd,df->bsf", yn, fp["wi"].to(x.dtype))
    hdn = constrain(dp, hdn, ("batch", "seq", "mlp"), tag="slstm/ffn")
    out = y + torch.einsum("bsf,fd->bsd", hdn, fp["wo"].to(x.dtype))
    out = constrain(dp, out, ("batch", "seq", "embed"), tag="slstm/out")
    return out, {"h": hh, "c": c, "n": n, "m": m}


def xlstm_state_slot_insert(state: dict, prefilled: dict, slot: int) -> dict:
    """Write one prefilled request's xLSTM block state (batch row 0 of a
    batch-1 state dict from :func:`mlstm_state_init` /
    :func:`slstm_state_init`) into slot ``slot`` of a persistent
    multi-slot state, in place.  Every leaf is an O(1) summary, so the
    insert replaces the slot's state wholesale; once the model stacks the
    block-repeat axis in front (models/xlstm_model.py) the engine uses
    ``state_slot_insert`` on the whole cache instead."""
    return state_slot_insert(state, prefilled, slot, batch_axis=0)


__all__ = [
    "mlstm_init", "mlstm", "mlstm_state_init",
    "slstm_init", "slstm", "slstm_state_init",
    "xlstm_state_slot_insert",
]
