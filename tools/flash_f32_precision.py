#!/usr/bin/env python3
"""How many TF32 tensor-core products the f32 flash kernels need: their
products mirrored in plain torch on the CPU and held against the plain
versions.

    python3 tools/flash_f32_precision.py [--seed 0] [--out ratios.json]

The f32 forward and backward of ``kernels/flash_attention/csrc/
flash_attention.cu`` run every f32 product A.B on the tensor cores as
TF32 ``mma.sync`` (m16n8k8).  Each operand x is split into hi = tf32(x)
and lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero, on 10 mantissa bits).  A product of two
TF32 values is exact in f32.  How the tensor core rounds its f32 sums is
not documented, so the mirror takes the worse case, truncation: each
mma's sum is rounded toward zero.  It runs the kernels' six products (S
= Q.K^T and O = P.V in the forward; S, dP = dO.V^T, dV = P^T.dO, dK =
dS^T.Q and dQ = dS.K in the backward) with each of:

* ``tf32x1``: one product a k-step of 8, A_hi.B_hi into fresh
  registers, the k-steps' sums added in f32 (round to nearest);
* ``tf32x3``: three a k-step, A_lo.B_hi, then A_hi.B_lo, then A_hi.B_hi
  chained into fresh registers, the k-steps' sums added in f32: as the
  kernels run them;
* ``tf32x3_chained``: the same three products chained through one
  accumulator over all k-steps, every sum inside the tensor core;

at ``chip_smoke.py``'s f32 cases: phase 2's (B=1 S=200, 4 over 1 heads,
D 16, window 8), 11a's (B=2 S=64, the same heads, window 8) and 11c's
(B=2 S=256, 8 over 4 heads, D 64, global), causal, with q = 3 N(0, 1),
k and do N(0, 1) and v uniform in [-1.5, 1.5) (numpy, from ``--seed``).
It prints the worst error over each gate of the card's checks: the
output's |o - plain| / 2e-5, the lse's / (2e-5 max(1, |lse|)) against
``ops.flash_attention_plain``, and each gradient's / (2e-5 max(1,
|plain|)) against ``ref.flash_attention_bwd_plain`` from the plain
forward's o and lse.  A gate holds at a ratio of at most 1.  CPU only.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-5
NEG_INF = -2.0**30
# label: (B, S, H, KVH, D, window)
CASES = {"phase2": (1, 200, 4, 1, 16, 8),
         "11a": (2, 64, 4, 1, 16, 8),
         "11c": (2, 256, 8, 4, 64, 0)}
# candidate: (products a k-step, the k-steps' sums added outside the
# tensor core)
PRODUCTS = {"tf32x1": (1, True), "tf32x3": (3, True),
            "tf32x3_chained": (3, False)}
KSTEP = 8   # the k of mma.sync m16n8k8


def tf32(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: half an
    ulp of 10 mantissa bits added to the magnitude, the 13 bits below
    them cleared (on the int32 view)."""
    import torch
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """x as the kernels split it: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def _rz(x64):
    """float64 to float32, rounded toward zero."""
    import torch
    x = x64.float()
    return torch.where(x.double().abs() > x64.abs(),
                       torch.nextafter(x, torch.zeros_like(x)), x)


def matmul(a, b, candidate: str):
    """a @ b (the inner size a multiple of 8) as ``candidate`` computes
    it: by k-steps of 8, each mma's exact sum of TF32 products rounded
    toward zero."""
    products, outside = PRODUCTS[candidate]
    (ah, al), (bh, bl) = split(a), split(b)
    acc = None
    for k0 in range(0, a.shape[-1], KSTEP):
        ks = slice(k0, k0 + KSTEP)
        def dot(x, y):
            return x[..., ks].double() @ y[..., ks, :].double()
        t = None if outside or acc is None else acc.double()
        if products == 3:   # the small terms first
            for x, y in ((al, bh), (ah, bl)):
                t = _rz(dot(x, y) if t is None else t.double() + dot(x, y))
        t = _rz(dot(ah, bh) if t is None else t.double() + dot(ah, bh))
        acc = t if not outside else t if acc is None else acc + t
    return acc


def _mask(sq: int, skv: int, window: int):
    import torch
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None]
    mask = kp <= qp
    if window:
        mask &= qp - kp < window
    return mask


def _heads(k, g: int):
    """(B, S, KVH, D) as (B, H, S, D), each kv head repeated over its
    group of g query heads."""
    return k.transpose(1, 2).repeat_interleave(g, dim=1)


def forward(q, k, v, window: int, candidate: str):
    """The forward's products in the mirror: o (B, S, H, D) and the
    natural-log lse (B, H, S)."""
    import torch
    g = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3])
    qh, kh, vh = q.transpose(1, 2), _heads(k, g), _heads(v, g)
    mask = _mask(q.shape[1], k.shape[1], window)
    s = matmul(qh, kh.transpose(-1, -2), candidate) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    o = matmul(p, vh, candidate) / l.clamp(min=1e-30)
    return o.transpose(1, 2), (m + torch.log(l)).squeeze(-1)


def backward(q, k, v, o, lse, do, window: int, candidate: str):
    """The backward's products in the mirror: dq, dk, dv from the
    forward's o and lse (B, H, S)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)
    kh, vh = _heads(k, g), _heads(v, g)
    mask = _mask(sq, skv, window)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    s = matmul(qh, kh.transpose(-1, -2), candidate) * scale
    p = (s - lse[..., None]).exp() * mask
    dp = matmul(doh, vh.transpose(-1, -2), candidate)
    ds = p * (dp - delta)
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = matmul(pt, doh, candidate)
    dk = matmul(dst, qh, candidate) * scale
    dq = matmul(ds, kh, candidate) * scale

    def per_kv_head(t):   # (B, H, Skv, D) summed over each group
        return t.reshape(b, kvh, g, skv, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), per_kv_head(dk), per_kv_head(dv)


def inputs(case, seed: int):
    import numpy as np
    import torch
    b, s, h, kvh, d, _ = case
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (3 * rng.standard_normal((b, s, h, d)),
            rng.standard_normal((b, s, kvh, d)),
            rng.random((b, s, kvh, d)) * 3 - 1.5,
            rng.standard_normal((b, s, h, d)))
    return tuple(torch.from_numpy(a.astype(f)) for a in arrs)


def ratios(case, seed: int = 0, candidates=tuple(PRODUCTS)) -> dict:
    """Worst error over its gate of each output, for each candidate."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)

    window = case[5]
    q, k, v, do = inputs(case, seed)
    po, plse = ops.flash_attention_plain(q, k, v, window=window,
                                         return_lse=True)
    plse = plse.reshape(plse.shape[0], -1, plse.shape[-1])   # (B, H, S)
    want = flash_attention_bwd_plain(q, k, v, po, plse.reshape(
        plse.shape[0], k.shape[2], -1, plse.shape[-1]), do, causal=True,
        window=window)
    out = {}
    for name in candidates:
        o, lse = forward(q, k, v, window, name)
        grads = backward(q, k, v, po, plse, do, window, name)
        r = {"o": float((o - po).abs().max() / TOL),
             "lse": float(((lse - plse).abs()
                           / (TOL * plse.abs().clamp(min=1.0))).max())}
        for gname, got, w in zip(("dq", "dk", "dv"), grads, want):
            r[gname] = float(((got - w).abs()
                              / (TOL * w.abs().clamp(min=1.0))).max())
        out[name] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(4)
    res = {}
    for label, case in CASES.items():
        res[label] = ratios(case, args.seed)
        for name, r in res[label].items():
            print(f"{label} {name}: worst ratio {max(r.values()):.4f} ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in r.items()) + ")",
                  flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"seed": args.seed, "cases": CASES, "ratios": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
