"""Plain-torch versions of the SSM selective scan.

* :func:`ssm_scan_ref` — the oracle: a literal loop over time,
  independent of the kernel and of the model's code, like ``repro``'s
  ``ref.py``.
* :func:`ssm_scan_chunked_ref` — the Hopper kernel's chunked algorithm
  in plain torch (the tests hold it against the oracle): chunks scanned
  from zero state with their decay as a product of per-step factors, a
  carry over the chunks, and a rescan from the carried states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def ssm_scan_chunked_ref(dt, x, a, b, c, h0, chunk_len: int, n_chunks: int):
    """The kernel's algorithm on a plan from ``ops.chunk_plan``: ``s`` steps
    cut into ``n_chunks`` chunks of ``chunk_len`` (the last may be
    shorter).  Pass 1 scans chunks 0..n-2 (chunk 0 from h0, the rest from
    0) and keeps each end state and its decay, the product of the step
    factors exp(dt_t * a); the carry runs H_k = decay_k * H_{k-1} + end_k;
    pass 2 rescans every chunk from h0 or H_{k-1} and emits y.  Returns
    (y, h_final), float32."""
    dt, x, a, b, c, h0 = (t.float() for t in (dt, x, a, b, c, h0))
    bsz, s, di = dt.shape
    n = a.shape[1]
    if chunk_len * (n_chunks - 1) >= s or chunk_len * n_chunks < s:
        raise ValueError(f"plan ({chunk_len}, {n_chunks}) does not cut "
                         f"{s} steps into non-empty chunks")
    pad = chunk_len * n_chunks - s

    def cut(t):
        # (B, K, L, ·); steps past s have dt = 0: factor 1, no input
        return F.pad(t, (0, 0, 0, pad)).view(bsz, n_chunks, chunk_len, -1)

    dtc, xc, bc, cc = cut(dt), cut(x), cut(b), cut(c)

    def step(h, i):
        f = torch.exp(dtc[:, :, i, :, None] * a)                # (B,K,di,N)
        u = (dtc[:, :, i] * xc[:, :, i])[..., None] * bc[:, :, i, None, :]
        return f, f * h + u

    h = torch.zeros((bsz, n_chunks, di, n))
    h[:, 0] = h0
    dec = torch.ones_like(h)
    for i in range(chunk_len):                                  # pass 1
        f, h = step(h, i)
        dec = dec * f
    starts = [h0]                                               # carry
    if n_chunks > 1:
        state = h[:, 0]
        starts.append(state)
        for k in range(1, n_chunks - 1):
            state = dec[:, k] * state + h[:, k]
            starts.append(state)
    h = torch.stack(starts, dim=1)
    ys = []
    for i in range(chunk_len):                                  # pass 2
        _, h = step(h, i)
        ys.append(torch.einsum("bkdn,bkn->bkd", h, cc[:, :, i]))
    y = torch.stack(ys, dim=2).reshape(bsz, n_chunks * chunk_len, di)
    return y[:, :s], h[:, -1]


__all__ = ["ssm_scan_ref", "ssm_scan_chunked_ref"]
