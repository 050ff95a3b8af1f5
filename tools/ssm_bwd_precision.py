#!/usr/bin/env python3
"""Which arithmetic the scan's backward kernel can afford: each candidate
mirrored in plain torch on the CPU and held against the float64 gradient.

    python3 tools/ssm_bwd_precision.py [--shape 2 256 3200 16] [--seed 0]
        [--slice 320]

At hymba-1.5b's train shape (a rank's 2 x 256, d_inner 3200, N 16) with
mamba's dt (log-uniform in [1e-3, 1e-1]) and A = -(1..N), and standard
normal x, b, c, h0 and cotangents (numpy, from ``--seed``), it runs the
backward kernel's algorithm (``ref.ssm_scan_bwd_tiled_ref``'s tiles,
copied here with the arithmetic as an argument) with each candidate's
arithmetic:

* ``f64_exp``: float64 throughout, ``torch.exp``;
* ``f64_table_exp_deg{3,4,5}``: float64 with the kernel's table
  exponential (``ref.exp_f64``; the kernel takes degree 4) at three
  degrees of its polynomial;
* ``f32_expf``: float64 chains, the factor ``expf`` of ``dt * a`` in
  float32, widened;
* ``f32_chains``: the state and the cotangent rounded to float32 after
  every step, the factor as in ``f32_expf``, every sum in float64;

and prints, for each gradient in float32, the worst of ``|got - ref| /
(2e-5 * max(1, |ref|))`` against ``ref.ssm_scan_bwd_plain`` (the gate of
``chip_smoke.py``'s phase 2b is a ratio of at most 1).  The channels run
``--slice`` at a time; d b and d c add up over the slices.  CPU only.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-5
NAMES = ("dt", "x", "a", "b", "c", "h0")


def candidates():
    import torch
    from repro_torch.kernels.ssm_scan import ref

    def expf(x):
        return torch.exp(x.float()).double()

    def f32(t):
        return t.float().double()

    tables = {f"f64_table_exp_deg{d}": dict(
        exp=lambda x, d=d: ref.exp_f64(x, degree=d)) for d in (3, 4, 5)}
    return {"f64_exp": dict(exp=torch.exp), **tables,
            "f32_expf": dict(exp=expf),
            "f32_chains": dict(exp=expf, chain=f32)}


def tiled_bwd(dt, x, a, b, c, h0, gy, ghf, exp, chain=None):
    """``ref.ssm_scan_bwd_tiled_ref`` on float64 inputs with the factor's
    exponential ``exp`` and, when given, ``chain`` rounding the state and
    the cotangent after every step; the six gradients in float64."""
    import torch
    from repro_torch.kernels.ssm_scan import ref

    rnd = chain or (lambda t: t)
    bsz, s, di = dt.shape
    tile = ref.BWD_TILE
    g, dtx = rnd(ghf), dt * x
    n_tiles = -(-s // tile)

    def step(h, t):
        f = exp(dt[:, t, :, None] * a)
        fh = f * h
        return f, fh, rnd(fh + dtx[:, t, :, None] * b[:, t, None, :])

    starts, h = [h0], h0
    for t in range((n_tiles - 1) * tile):
        h = step(h, t)[2]
        if (t + 1) % tile == 0:
            starts.append(h)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros((bsz,) + a.shape, dtype=torch.float64)
    for k in reversed(range(n_tiles)):
        lo, hi = k * tile, min(s, (k + 1) * tile)
        h, kept = starts[k], []
        for t in range(lo, hi):
            f, fh, h = step(h, t)
            kept.append((f, fh))
            dc[:, t] = torch.einsum("bdn,bd->bn", h, gy[:, t])
        for t in reversed(range(lo, hi)):
            f, fh = kept[t - lo]
            g = rnd(g + gy[:, t, :, None] * c[:, t, None, :])
            gf = g * fh
            s_u = (g * b[:, t, None, :]).sum(-1)
            ddt[:, t] = (gf * a).sum(-1) + x[:, t] * s_u
            dx[:, t] = dt[:, t] * s_u
            da += gf * dt[:, t, :, None]
            db[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
            g = rnd(f * g)
    return ddt, dx, da.sum(0), db, dc, g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=4, default=(2, 256, 3200, 16))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slice", type=int, default=320)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels.ssm_scan import ref

    torch.set_num_threads(4)
    bsz, s, di, n = args.shape
    rng = np.random.default_rng(args.seed)
    f = np.float32
    dt = np.exp(math.log(1e-3) + rng.random((bsz, s, di)) * math.log(100.0))
    arrs = [dt.astype(f), rng.standard_normal((bsz, s, di)).astype(f),
            -np.broadcast_to(np.arange(1, n + 1, dtype=f), (di, n)).copy(),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, di, n)).astype(f),
            rng.standard_normal((bsz, s, di)).astype(f),
            rng.standard_normal((bsz, di, n)).astype(f)]
    dt, x, a, b, c, h0, gy, ghf = (torch.from_numpy(t) for t in arrs)
    cands = candidates()
    ref_parts, got_parts = [], {k: [] for k in cands}
    for lo in range(0, di, args.slice):
        sl = slice(lo, min(di, lo + args.slice))
        part = (dt[:, :, sl], x[:, :, sl], a[sl], b, c, h0[:, sl],
                gy[:, :, sl], ghf[:, sl])
        ref_parts.append(ref.ssm_scan_bwd_plain(*(t.double() for t in part)))
        for name, kw in cands.items():
            got_parts[name].append(tiled_bwd(
                *(t.double() for t in part), **kw))

    def whole(parts):
        # channel axes: dt, x (2), a (0), h0 (1); b and c add up
        cat = [torch.cat([p[i] for p in parts], dim=d)
               for i, d in ((0, 2), (1, 2), (2, 0))]
        sums = [sum(p[i] for p in parts) for i in (3, 4)]
        return cat + sums + [torch.cat([p[5] for p in parts], dim=1)]

    want = [t.float().double() for t in whole(ref_parts)]
    res = {}
    for name in cands:
        got = [t.float().double() for t in whole(got_parts[name])]
        ratios = {nm: float(((g - w).abs() / (TOL * w.abs().clamp(min=1.0)))
                            .max()) for nm, g, w in zip(NAMES, got, want)}
        res[name] = ratios
        print(f"{name}: worst ratio {max(ratios.values()):.4f} ("
              + ", ".join(f"d{k} {v:.4f}" for k, v in ratios.items()) + ")",
              flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"shape": list(args.shape), "seed": args.seed, "ratios": res},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
