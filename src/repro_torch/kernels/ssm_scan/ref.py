"""Plain-torch versions of the SSM selective scan.

* :func:`ssm_scan_ref` — the oracle: a literal loop over time,
  independent of the kernel and of the model's code, like ``repro``'s
  ``ref.py``.
* :func:`ssm_scan_chunked_ref` — the Hopper kernel's chunked algorithm
  in plain torch (the tests hold it against the oracle): chunks scanned
  from zero state with their decay as a product of per-step factors, a
  carry over the chunks, and a rescan from the carried states.
* :func:`ssm_scan_bwd_plain` — the scan's gradient, the backward of
  ``ops.SSMScan``.  ``repro`` has no backward kernel: it differentiates
  its chunked scan (``associative_scan`` per chunk inside ``lax.scan``)
  through XLA, and this is a plain-torch port of that gradient.
* :func:`ssm_scan_bwd_tiled_ref` — the Hopper backward kernel's
  algorithm and its float64 exponential :func:`exp_f64` in plain torch
  (the tests hold it against the plain gradient and ``jax.grad``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ssm_scan_ref(dt, x, a, b, c, h0):
    """dt/x: (B, S, di); a: (di, N); b/c: (B, S, N); h0: (B, di, N).

    Returns (y: (B, S, di), h_final: (B, di, N)), both float32 (float64
    for float64 inputs)."""
    wide = torch.promote_types(dt.dtype, torch.float32)
    dt, x, a, b, c, h = (t.to(wide) for t in (dt, x, a, b, c, h0))
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


# time steps a chunk of the backward: a chunk's (B, L, di, N) tensors are
# the largest it holds, never the whole sequence's
BWD_CHUNK = 64


def _scan(f, u):
    """Inclusive scan over dim 1 of ``h_i = f_i * h_{i-1} + u_i`` from
    h = 0, by doubling (``log2 L`` vectorised levels, as an associative
    scan): returns (F, U), F_i the product of f_0..f_i and U_i the scan,
    so that the scan from a start state H is ``F * H + U``."""
    n = f.shape[1]
    off = 1
    while off < n:
        u = torch.cat([u[:, :off], torch.addcmul(u[:, off:], f[:, off:],
                                                 u[:, :-off])], dim=1)
        f = torch.cat([f[:, :off], f[:, off:] * f[:, :-off]], dim=1)
        off *= 2
    return f, u


def ssm_scan_bwd_plain(dt, x, a, b, c, h0, gy, ghf):
    """Gradients (d dt, d x, d a, d b, d c, d h0) of ``(y, h_final) =
    scan(dt, x, a, b, c, h0)`` for output cotangents ``gy`` (B, S, di)
    and ``ghf`` (B, di, N) (either may be None: zero), each in its
    input's dtype, computed in float64: over a state that lives hundreds
    of steps (mamba's dt and A) a float32 backward, ``repro``'s XLA
    gradient included, is off the exact gradient by more than 2e-5 of
    d dt and d c where their terms cancel.

    The cotangent of the state h_t runs backward in time,
    ``g_t = exp(dt_{t+1} a) * g_{t+1} + gy_t (x) c_t`` from ``ghf``, and
    each step's gradients come from g_t and the recomputed states h_t
    and h_{t-1}.  Both recurrences run :data:`BWD_CHUNK` steps at a
    time: a forward pass over the chunks keeps only each chunk's start
    state (B, S / chunk, di, N); then, from the last chunk to the first, the
    chunk's states are rescanned from its start, its cotangents scanned
    backward from the carry of the chunk after it, and its gradients
    summed.  No tensor spans the whole sequence with the state axis."""
    dtypes = [t.dtype for t in (dt, x, a, b, c, h0)]
    f64 = torch.float64
    dt, x, a, b, c, h0 = (t.to(f64) for t in (dt, x, a, b, c, h0))
    bsz, s, di = dt.shape
    n = a.shape[1]
    gy = torch.zeros_like(dt) if gy is None else gy.to(f64)
    g = torch.zeros_like(h0) if ghf is None else ghf.to(f64).clone()
    chunk = BWD_CHUNK
    bounds = [(i, min(i + chunk, s)) for i in range(0, s, chunk)]

    def factors(lo, hi):
        f = torch.exp(dt[:, lo:hi, :, None] * a)                # (B,L,di,N)
        u = (dt[:, lo:hi] * x[:, lo:hi])[..., None] * b[:, lo:hi, None, :]
        return f, u

    starts = [h0]                        # forward: each chunk's start
    for lo, hi in bounds[:-1]:
        f, u = factors(lo, hi)
        fc, uc = _scan(f, u)
        starts.append(fc[:, -1] * starts[-1] + uc[:, -1])
        del f, u, fc, uc

    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(a)
    for (lo, hi), start in zip(reversed(bounds), reversed(starts)):
        f, u = factors(lo, hi)
        fc, uc = _scan(f, u)
        h = fc * start[:, None] + uc                            # h_lo..h_hi-1
        del fc, uc
        e = gy[:, lo:hi, :, None] * c[:, lo:hi, None, :]
        # backward in time: g_i = f_{i+1} g_{i+1} + e_i, g_last = carry + e
        fr = torch.cat([torch.ones_like(f[:, :1]), f[:, 1:].flip(1)], dim=1)
        fcr, ucr = _scan(fr, e.flip(1))
        gh = (fcr * g[:, None] + ucr).flip(1)                  # (B,L,di,N)
        del fr, fcr, ucr, e
        h_prev = torch.cat([start[:, None], h[:, :-1]], dim=1)
        dc[:, lo:hi] = torch.einsum("bldn,bld->bln", h, gy[:, lo:hi])
        del h
        gf = gh * h_prev * f                     # d/d(dt a) of each factor
        del h_prev
        g_u = torch.einsum("bldn,bln->bld", gh, b[:, lo:hi])   # d(dt x)
        ddt[:, lo:hi] = torch.einsum("bldn,dn->bld", gf, a) \
            + g_u * x[:, lo:hi]
        dx[:, lo:hi] = g_u * dt[:, lo:hi]
        da += torch.einsum("bldn,bld->dn", gf, dt[:, lo:hi])
        db[:, lo:hi] = torch.einsum("bldn,bld->bln", gh,
                                    dt[:, lo:hi] * x[:, lo:hi])
        g = f[:, 0] * gh[:, 0]             # the cotangent of the start
        del gf, gh, f, u
    grads = (ddt, dx, da, db, dc, g)
    return tuple(t.to(want) for t, want in zip(grads, dtypes))


# the backward kernel's time tile: a chain's state is kept at every tile
# start, and a tile's factors and states are rescanned into registers
BWD_TILE = 8
_LN2 = math.log(2.0)
# 2^(i/16), i = 0..15: the float64 exponential's table
EXP_TABLE = [2.0 ** (i / 16) for i in range(16)]
EXP_DEGREE = 4     # the degree of its polynomial


def exp_f64(x, degree: int = EXP_DEGREE):
    """The backward kernel's float64 exponential: ``x = j ln2 / 16 + r``
    with j the nearest integer and ``|r| <= ln2 / 32``, ``exp(x) =
    2^(j >> 4) * 2^((j & 15) / 16) * p(r)`` with ``p`` exp's Taylor
    polynomial of ``degree`` (the kernel's 4: a relative error below
    4.1e-11).  Where ``|x|`` is not below 700 (and for NaN) it is
    ``torch.exp``, as the kernel falls back to libdevice's ``exp``
    there."""
    j = torch.round(x * (16.0 / _LN2))
    r = x - j * (_LN2 / 16.0)
    p = torch.full_like(r, 1.0 / math.factorial(degree))
    for k in range(degree - 1, -1, -1):
        p = p * r + 1.0 / math.factorial(k)
    ok = x.abs() < 700.0
    ji = torch.where(ok, j, torch.zeros_like(j)).to(torch.int64)
    table = torch.tensor(EXP_TABLE, dtype=torch.float64, device=x.device)
    y = torch.ldexp(table[ji & 15] * p, (ji >> 4).to(torch.float64))
    return torch.where(ok, y, torch.exp(x))


def ssm_scan_bwd_tiled_ref(dt, x, a, b, c, h0, gy, ghf):
    """The backward kernel's algorithm in plain torch, for the tests: the
    same gradients as :func:`ssm_scan_bwd_plain`, each in its input's
    dtype.  Each (row, channel, state) chain is walked in time by one
    thread, ``BWD_TILE`` steps at a time.  A forward sweep keeps the state
    at every tile start; then, from the last tile to the first, a tile's
    factors ``f_t = exp(dt_t a)`` (the kernel's :func:`exp_f64`) and
    products ``f_t h_{t-1}`` are rescanned from its start state (the
    terms of d c on the way), and the cotangent ``g`` walks back through
    it from the one the tile after it sent.  d a is summed per batch row,
    then over rows.  Everything runs in float64."""
    dtypes = [t.dtype for t in (dt, x, a, b, c, h0)]
    f64 = torch.float64
    dt, x, a, b, c, h0 = (t.to(f64) for t in (dt, x, a, b, c, h0))
    bsz, s, di = dt.shape
    gy = torch.zeros_like(dt) if gy is None else gy.to(f64)
    g = torch.zeros_like(h0) if ghf is None else ghf.to(f64)
    dtx = dt * x
    tile = BWD_TILE
    n_tiles = -(-s // tile)

    def step(h, t):
        f = exp_f64(dt[:, t, :, None] * a)
        fh = f * h
        return f, fh, fh + dtx[:, t, :, None] * b[:, t, None, :]

    starts, h = [h0], h0
    for t in range((n_tiles - 1) * tile):       # the forward sweep
        h = step(h, t)[2]
        if (t + 1) % tile == 0:
            starts.append(h)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros((bsz,) + a.shape, dtype=f64)
    for k in reversed(range(n_tiles)):
        lo, hi = k * tile, min(s, (k + 1) * tile)
        h, kept = starts[k], []
        for t in range(lo, hi):                 # the rescan
            f, fh, h = step(h, t)
            kept.append((f, fh))
            dc[:, t] = torch.einsum("bdn,bd->bn", h, gy[:, t])
        for t in reversed(range(lo, hi)):       # the walk back
            f, fh = kept[t - lo]
            g = g + gy[:, t, :, None] * c[:, t, None, :]
            gf = g * fh
            s_dt = (gf * a).sum(-1)
            s_u = (g * b[:, t, None, :]).sum(-1)
            ddt[:, t] = s_dt + x[:, t] * s_u
            dx[:, t] = dt[:, t] * s_u
            da += gf * dt[:, t, :, None]
            db[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
            g = f * g
    grads = (ddt, dx, da.sum(0), db, dc, g)
    return tuple(t.to(want) for t, want in zip(grads, dtypes))


__all__ = ["ssm_scan_ref", "ssm_scan_chunked_ref", "ssm_scan_bwd_plain",
           "ssm_scan_bwd_tiled_ref", "exp_f64", "BWD_CHUNK", "BWD_TILE"]
