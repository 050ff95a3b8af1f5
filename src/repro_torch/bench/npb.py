"""NPB-style MPI benchmark suite over the CoRD dataplane (paper Fig. 6);
the port of ``benchmarks/npb.py``.

    python -m repro_torch.bench.npb [--bench EP ...] [--device cpu]

Five kernels with the paper's communication profiles, running on an
8-rank ``("rank",)`` mesh with every collective issued through the
dataplane (bypass / cord / socket modes — socket ≈ IPoIB):

  EP — embarrassingly parallel (one tiny all-reduce at the end)
  IS — integer bucket sort (histogram psum + all-to-all key exchange;
       message- AND data-intensive — the paper's worst case for IPoIB)
  CG — conjugate-gradient iterations on a banded operator (halo
       ppermute + dot-product psums; few large messages)
  FT — 2-D pencil FFT (large all-to-all transposes; data-intensive)
  MG — multigrid V-cycle (halo exchanges at every level; many small
       messages)

``repro`` runs each body under ``shard_map`` on 8 host devices; here the
8 ranks are the leading dim of rank-stacked tensors on one device
(``launch/mesh.py``), each rank's arithmetic a slice of one batched op,
and every collective the dataplane's explicit one over that dim.  Every
kernel threads the dataplane's per-tenant runtime state through its body
with the uniform ``(x, state)`` convention, so in ``cord``/``socket``
mode the runtime op/byte counters are bumped on the measured path (the
per-op mediation work).  On the card each mediated collective launches
the dataplane kernel once a rank and side with work.

Two accountings are reported, as in ``repro``:

* ``comm_*`` is ``repro``'s *trace-time* telemetry: ``jax.jit`` traces a
  body once however often it runs, and ``lax.scan`` traces its step
  once.  The port records only what such a trace would: the first call's
  ops, and of a loop that ``repro`` scans, the first iteration's; every
  other op runs under :meth:`Dataplane.recomputing`, which runs the whole
  pipeline but records nothing.  A Python loop ``repro`` unrolls (MG's
  levels) is recorded at every turn.
* ``rt_*`` is the runtime state after one call: every executed op.

EP and IS draw their random numbers inside the body with ``jax.random``
in ``repro``, a stream this package does not have.  Here each draw comes
from a ``torch.Generator`` seeded from the ``build_*`` function's
``seed``, the rank and the step, or from the ``draw(rank, step, shape)``
function the caller gives (the parity tests pass JAX's draws).  Inputs are drawn the
same way, from seeds 3-6 as ``repro``'s keys.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from repro_torch.configs.base import DataplaneConfig
from repro_torch.core.dataplane import Dataplane
from repro_torch.launch.mesh import make_mesh as _mesh
from repro_torch.device import resolve_device

RANKS = 8


def make_mesh():
    return _mesh((RANKS,), ("rank",))


def make_dp(mode: str, mesh, *, syscall_ns=1500.0, interrupt_us=45.0,
            socket_ns=4000.0, socket_ns_per_byte=1.1,
            device=None) -> Dataplane:
    return Dataplane(DataplaneConfig(
        mode=mode, emulate_costs=True, syscall_cost_ns=syscall_ns,
        interrupt_cost_us=interrupt_us, socket_stack_ns=socket_ns,
        socket_ns_per_byte=socket_ns_per_byte),
        mesh=mesh, device=device)


def _traced(dp: Dataplane, body):
    """``body`` as ``repro``'s jitted function: only its first call
    records its dataplane ops (its trace); every later call runs them
    under ``dp.recomputing()``."""
    calls = [0]

    def fn(arg, rt):
        calls[0] += 1
        with dp.recomputing() if calls[0] > 1 else contextlib.nullcontext():
            return body(arg, rt)

    return fn


def _scan_step(dp: Dataplane, i: int):
    """The context of step ``i`` of a loop ``repro`` runs as a
    ``lax.scan``: its body is traced once, so only step 0 records."""
    return dp.recomputing() if i > 0 else contextlib.nullcontext()


def _ring(shift: int) -> list[tuple[int, int]]:
    return [(i, (i + shift) % RANKS) for i in range(RANKS)]


def _halo(dp: Dataplane, x, rt, tag_r: str, tag_l: str):
    """``x`` (ranks, n) between its neighbours' boundary elements: rank
    ``i`` gets rank ``i - 1``'s last element on its left and rank
    ``i + 1``'s first on its right, wrapping around."""
    left, rt = dp.ppermute(x[:, -1:].contiguous(), "rank", _ring(1),
                           tag=tag_r, state=rt)
    right, rt = dp.ppermute(x[:, :1].contiguous(), "rank", _ring(-1),
                            tag=tag_l, state=rt)
    return torch.cat([left, x, right], dim=1), rt


def _generator_draw(seed: int, kind: str, device):
    """``draw(rank, step, shape)``: uniform float32 in [0, 1) or int32 in
    [0, 2^20), from a generator seeded by ``seed``, the rank and the
    step, so a draw does not depend on the order of the others."""
    def draw(rank: int, step: int, shape):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + rank * 1000 + step)
        if kind == "uniform":
            return torch.rand(shape, generator=gen, device=device)
        return torch.randint(0, 2**20, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return draw


def _draws(draw, step: int, shape, device):
    """Every rank's draw of ``step``, stacked on the rank dim."""
    return torch.stack([torch.as_tensor(draw(r, step, shape)).to(device)
                        for r in range(RANKS)])


# ---------------------------------------------------------------------------
# kernels — every body is (arg, state) -> (out, state)
# ---------------------------------------------------------------------------

def build_ep(mesh, dp: Dataplane, n_per_rank: int = 1 << 18,
             steps: int = 4, *, seed: int = 0, draw=None):
    draw = draw or _generator_draw(seed, "uniform", dp.device)

    def body(seed_arg, rt):
        s = torch.zeros(RANKS, device=dp.device)
        for i in range(steps):
            xy = _draws(draw, i, (n_per_rank, 2), dp.device) * 2 - 1
            r2 = (xy ** 2).sum(-1)
            acc = torch.where(r2 <= 1.0, 1.0, 0.0).sum(-1)
            s = s + acc
        out, rt = dp.psum(s, "rank", tag="ep/final", state=rt)
        return out[0] + 0.0 * seed_arg, rt

    return _traced(dp, body)


def build_is(mesh, dp: Dataplane, n_per_rank: int = 1 << 14,
             steps: int = 8, *, seed: int = 1, draw=None):
    nbuckets = RANKS
    draw = draw or _generator_draw(seed, "randint", dp.device)

    def body(keys, rt):  # (RANKS, n) int32, one row a rank
        k = keys
        for i in range(steps):
            with _scan_step(dp, i):
                # bucket by top bits → destination rank
                dest = torch.div(k, 2**20 // nbuckets, rounding_mode="floor")
                hist = torch.zeros((RANKS, nbuckets), dtype=torch.int32,
                                   device=k.device).scatter_add_(
                    1, dest.long(), torch.ones_like(k))
                hist, rt = dp.psum(hist, "rank", tag="is/histogram",
                                   state=rt)
                # sort locally by destination, then all-to-all exchange
                order = torch.argsort(dest, dim=-1, stable=True)
                ks = torch.gather(k, 1, order).reshape(RANKS, nbuckets, -1)
                recv, rt = dp.all_to_all(ks, "rank", tag="is/exchange",
                                         split_axis=0, concat_axis=0,
                                         state=rt)
                k2 = torch.sort(recv.reshape(RANKS, -1), dim=-1).values
                # re-randomize for the next iteration (keeps sizes static)
                k = _draws(draw, i, (n_per_rank,), k.device) \
                    + (k2[:, :1] & 0)
        return k, rt

    return _traced(dp, body)


def build_cg(mesh, dp: Dataplane, n_per_rank: int = 1 << 15,
             iters: int = 12):
    def halo_matvec(x, rt):
        # banded operator: 3-point stencil across the rank boundary
        xm, rt = _halo(dp, x, rt, "cg/halo_r", "cg/halo_l")
        return (2.0 * x - 0.5 * xm[:, :-2] - 0.5 * xm[:, 2:]
                + 0.01 * x), rt

    def dot(a, b):
        return (a * b).sum(-1)

    def body(b, rt):  # (RANKS, n) one rhs row a rank
        x = torch.zeros_like(b)
        r = b
        p = r
        rs, rt = dp.psum(dot(r, r), "rank", tag="cg/dot", state=rt)
        for i in range(iters):
            with _scan_step(dp, i):
                ap, rt = halo_matvec(p, rt)
                pap, rt = dp.psum(dot(p, ap), "rank", tag="cg/dot",
                                  state=rt)
                alpha = rs / torch.clamp_min(pap, 1e-30)
                x = x + alpha[:, None] * p
                r = r - alpha[:, None] * ap
                rs_new, rt = dp.psum(dot(r, r), "rank", tag="cg/dot",
                                     state=rt)
                p = r + (rs_new / torch.clamp_min(rs, 1e-30))[:, None] * p
                rs = rs_new
        return x, rt

    return _traced(dp, body)


def build_ft(mesh, dp: Dataplane, n: int = 512, steps: int = 3):
    # (n, n) grid, rows rank-sharded: FFT rows → transpose (all-to-all)
    # → FFT rows (= columns of the original) → inverse path.
    rows = n // RANKS

    def transpose(a, rt):  # (RANKS, rows, n) → (RANKS, n // RANKS, n)
        blocks = a.reshape(RANKS, rows, RANKS, n // RANKS) \
            .transpose(1, 2).contiguous()
        recv, rt = dp.all_to_all(blocks, "rank", tag="ft/transpose",
                                 split_axis=0, concat_axis=0, state=rt)
        return recv.reshape(RANKS, n, n // RANKS).transpose(1, 2), rt

    def body(grid, rt):  # (RANKS * rows, n), rows a rank
        g = grid.reshape(RANKS, rows, n).to(torch.complex64)
        for i in range(steps):
            with _scan_step(dp, i):
                g = torch.fft.fft(g, dim=-1)
                gt, rt = transpose(g, rt)
                gt = torch.fft.fft(gt, dim=-1)
                g, rt = transpose(gt, rt)
                g = torch.fft.ifft(g, dim=-1)
                g = (g * (1.0 + 1e-6)).to(torch.complex64)
        return g.real.reshape(RANKS * rows, n), rt

    return _traced(dp, body)


def build_mg(mesh, dp: Dataplane, n_per_rank: int = 1 << 14,
             cycles: int = 3, levels: int = 5):
    def smooth(x, rt, tag):
        xm, rt = _halo(dp, x, rt, f"mg/halo_r/{tag}", f"mg/halo_l/{tag}")
        return 0.25 * xm[:, :-2] + 0.5 * x + 0.25 * xm[:, 2:], rt

    def body(x, rt):  # (RANKS, n) one row a rank
        for c in range(cycles):
            with _scan_step(dp, c):
                grids = []
                g = x
                for lev in range(levels):          # restrict
                    g, rt = smooth(g, rt, f"d{lev}")
                    grids.append(g)
                    g = g.reshape(RANKS, -1, 2).mean(-1)
                for lev in reversed(range(levels)):  # prolong
                    g = torch.repeat_interleave(g, 2, dim=-1)
                    g, rt = smooth(g + grids[lev], rt, f"u{lev}")
                x = g
        return x, rt

    return _traced(dp, body)


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

def _normal(seed: int, shape):
    def make(device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device)
    return make


def _is_keys(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    return torch.randint(0, 2**20, (RANKS, 1 << 14), generator=gen,
                         device=device, dtype=torch.int32)


BENCHES = {
    "EP": (build_ep, lambda device: torch.zeros((), device=device)),
    "IS": (build_is, _is_keys),
    "CG": (build_cg, _normal(4, (RANKS, 1 << 15))),
    "FT": (build_ft, _normal(5, (512, 512))),
    "MG": (build_mg, _normal(6, (RANKS, 1 << 14))),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(fn, arg, rt, reps=3):
    """Best wall time over ``reps`` plus the (out, state) of the warmup;
    each run ends in a synchronisation of the device."""
    dev = arg.device
    result = fn(arg, rt)
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(arg, rt)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, result


def run_all(benches=None, modes=("bypass", "cord", "socket"), *,
            device=None, outputs: dict | None = None):
    """One row a kernel and mode; with ``outputs``, each run's output
    tensor lands there under ``(bench, mode)``."""
    device = resolve_device(device)
    mesh = make_mesh()
    rows = []
    for name, (build, arg_fn) in BENCHES.items():
        if benches and name not in benches:
            continue
        arg = arg_fn(device)
        base = None
        for mode in modes:
            dp = make_dp(mode, mesh, device=device)
            fn = build(mesh, dp)
            t, (out, rt) = _measure(fn, arg, dp.runtime_init())
            if outputs is not None:
                outputs[(name, mode)] = out
            if base is None:
                base = t
            comm = dp.telemetry.by_kind()
            runtime = dp.runtime_report(rt)[dp.tenant]
            rows.append({
                "table": "fig6", "bench": name, "mode": mode,
                "ms": round(t * 1e3, 2),
                "rel_runtime": round(t / base, 3),
                "comm_ops": int(sum(v["ops"] for v in comm.values())),
                "comm_mib": round(sum(v["bytes"] for v in comm.values())
                                  / 2**20, 2),
                "rt_ops": int(runtime["ops"]),
                "rt_mib": round(runtime["bytes"] / 2**20, 2),
            })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="append", choices=sorted(BENCHES),
                    help="run only this kernel (repeatable; default all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows = run_all(benches=args.bench, device=args.device)
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
