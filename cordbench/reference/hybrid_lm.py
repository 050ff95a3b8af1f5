"""Plain reference of the hybrid model the hymba cell trains: every block
runs causal GQA attention and a mamba (S6) branch side by side on the
same RMS-normed input, RMS-norms each branch's output, averages the two
into the residual, then a SwiGLU MLP; tied embeddings scaled by
sqrt(d_model); the loss is the mean next-token cross entropy.

The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
y_t = C_t . h_t is evaluated in chunks: a sequential pass inside every
chunk from a zero state, the chunk carries in order, then each chunk's
start state propagated through its cumulative decay.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cordbench.reference.common import (Precision, attention,
                                        layer_windows, rmsnorm, unstack)


def scan(dt, x, a, b, c, chunk: int = 64):
    """y (B, S, di) of the diagonal recurrence from a zero state; dt, x:
    (B, S, di); a: (di, N); b, c: (B, S, N); all float32."""
    bsz, s, di = dt.shape
    n = a.shape[1]
    pad = (-s) % chunk
    if pad:     # zero time steps: decay 1, no input, outputs dropped
        dt, x = F.pad(dt, (0, 0, 0, pad)), F.pad(x, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    # slices of the big (B, nc, T, di, N) arrays are taken once, by
    # unbind: a slice's gradient would otherwise fill a zero array of the
    # whole for every step
    da = torch.exp(dt[..., None] * a).view(bsz, nc, chunk, di, n)
    dbx = ((dt * x)[..., None] * b[:, :, None, :]).view(bsz, nc, chunk, di,
                                                         n)
    h = dbx.new_zeros((bsz, nc, di, n))
    local = []
    for da_t, dbx_t in zip(da.unbind(2), dbx.unbind(2)):
        h = da_t * h + dbx_t
        local.append(h)
    decay = torch.cumprod(da, dim=2)
    carry = dbx.new_zeros((bsz, di, n))
    starts = []
    for dec_k, loc_k in zip(decay[:, :, -1].unbind(1), local[-1].unbind(1)):
        starts.append(carry)
        carry = dec_k * carry + loc_k
    hs = torch.stack(local, dim=2) + decay * torch.stack(starts, dim=1)[
        :, :, None]
    y = torch.einsum("bktdn,bktn->bktd", hs, c.view(bsz, nc, chunk, n))
    return y.reshape(bsz, nc * chunk, di)[:, :s]


def mamba(h, p: dict, ssm: dict, prec: Precision):
    """The mamba branch of (B, S, D) from a zero state."""
    s = h.shape[1]
    di = p["D"].shape[0]
    n = ssm["state_size"]
    xz = prec.mm(h, p["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    w = p["conv"]                                      # (W, di)
    xp = F.pad(xi, (0, 0, w.shape[0] - 1, 0))
    conv = sum(xp[:, i:i + s] * w[i] for i in range(w.shape[0]))
    xi = F.silu(conv + p["conv_bias"])
    proj = prec.mm(xi, p["x_proj"])
    r = p["dt_proj"].shape[0]
    dt = F.softplus(prec.mm(proj[..., :r], p["dt_proj"]) + p["dt_bias"])
    y = scan(dt, xi, -torch.exp(p["A_log"]), proj[..., r:r + n],
             proj[..., r + n:r + 2 * n])
    y = (y + p["D"] * xi) * F.silu(z)
    return prec.mm(y, p["out_proj"])


def block(x, lp: dict, mcfg: dict, window: int, prec: Precision):
    a = mcfg["attention"]
    eps = mcfg["norm_eps"]
    h = rmsnorm(x, lp["norm1"]["scale"], eps)
    att = attention(h, lp["attn"], heads=a["num_heads"],
                    kv_heads=a["num_kv_heads"], theta=a["rope_theta"],
                    window=window, cap=a["logit_softcap"], prec=prec)
    m = mamba(h, lp["mamba"], mcfg["ssm"], prec)
    x = x + 0.5 * (rmsnorm(att, lp["attn_norm"]["scale"], eps)
                   + rmsnorm(m, lp["mamba_norm"]["scale"], eps))
    h = rmsnorm(x, lp["norm2"]["scale"], eps)
    mp = lp["mlp"]
    return x + prec.mm(F.silu(prec.mm(h, mp["wg"])) * prec.mm(h, mp["wi"]),
                       mp["wo"])


def loss(params: dict, mcfg: dict, tokens, labels,
         prec: Precision | None = None):
    """Mean cross entropy of ``labels`` (B, S) after ``tokens`` (B, S),
    each block recomputed in the backward."""
    prec = prec or Precision()
    tab = params["embed"]["tok"]
    x = tab[tokens].float() * math.sqrt(mcfg["d_model"])
    for lp, window in zip(unstack(params["layers"]), layer_windows(mcfg)):
        x = checkpoint(block, x, lp, mcfg, window, prec, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], mcfg["norm_eps"])
    logits = prec.mm(x, tab.t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
