"""Plain-torch oracle for the SSM selective scan: a literal loop over
time, independent of the kernel and of the model's code, like
``repro``'s ``ref.py``."""

from __future__ import annotations

import torch


def ssm_scan_ref(dt, x, a, b, c, h0):
    """dt/x: (B, S, di); a: (di, N); b/c: (B, S, N); h0: (B, di, N).

    Returns (y: (B, S, di), h_final: (B, di, N)), both float32."""
    dt, x, a, b, c, h = (t.float() for t in (dt, x, a, b, c, h0))
    ys = []
    for t in range(dt.shape[1]):
        dt_t, x_t = dt[:, t], x[:, t]                # (B, di)
        dA = torch.exp(dt_t[..., None] * a)          # (B, di, N)
        h = dA * h + (dt_t * x_t)[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else dt.new_zeros(dt.shape))
    return y, h


__all__ = ["ssm_scan_ref"]
