#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
H100.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, one line each; any failure raises and the script exits nonzero:

0. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the build of every Hopper kernel (bounce,
   flash_attention, ssm_scan) from the sources in the checkout (one
   ``nvcc`` per source, all started together);
1. the dataplane bounce/cost kernel against its plain version: bit
   identity and exact counters over f32/bf16/int32/uint8 payloads with
   NaN and -0.0, ragged / single / whole-chunk sizes, copies 0-3 and
   small to large delays; the ring's edges (storage offsets of 1, 4, 8
   and 15 bytes, sizes at 16 k +- 1 and at the ring tile +- 1, more tiles
   than the grid has blocks times stages); the delay chain's calibrated
   slope, which must be at least 1 ns an iteration; the same bit
   identity, then its time (CUDA events and profiler device time) against
   its bound and ``torch.clone``, the device time of its delay chain
   alone, and its host time per call, for the main path's payloads: the
   1.21 GB gemma3-1b embedding table, a bf16 (1, 512, 1152) activation
   and a 64 KB payload;
2. the flash-attention kernel against its plain version at gemma3-1b
   shapes and at hymba-1.5b's (D=64, H=25, KVH=5, window 1024), the
   main path's own prefill lengths, and shapes that cut its 64-row tiles
   (window 100, S=1, valid_len 0 and 130); bf16 max error bound 1e-2 on
   outputs of rms >= 0.3 (valid_len 0: exactly 0), bf16 D=16/32/128, an
   f32 D=16 case (bound 2e-5); its time (CUDA events, and device time
   from torch.profiler) against its bound and
   ``F.scaled_dot_product_attention``, its host time per call (1,000
   calls, no sync) beside SDPA's, and the host time of encoding its TMA
   tensor maps;
2b. the SSM-scan kernel against its plain version at hymba-1.5b shapes
   (d_inner 3200, N 16: prefill S = 1, 16, 31, 37, 300, 2048 and 4096,
   which cross its chunk plan, state that outlives a chunk (mamba's own
   dt and A) at S = 300 and 2048, a batch-4 prefill and the 4-slot decode
   tick in f32, one bf16 case, a ragged d_inner of 200; f32 bound 2e-5 *
   max(1, |ref|) on outputs of max |ref| >= 1), its time (CUDA events
   and profiler device time) against its byte bound, and its host time
   per call at decode;
3. the serving path at gemma3-1b's full width (26 layers, random weights
   from a seed, bf16 compute) through a ``cord`` dataplane with
   ``emulate_costs``: 8 requests on the continuous engine, the kernels'
   launch counts on that run, a repeat with identical tokens, and a run
   with ``pallas_dataplane="off"`` with identical tokens;
3c. the same model served from the paged KV pool (``block_size=16``,
   ``kv_cache_len=2560``, so 640 blocks) with chunked prefill
   (``prefill_chunk=512``): phase 3's 8 prompts and two of 1100 and 2000
   tokens (3 and 4 chunks), in five runs: (a) paged + chunked, (b) the
   same again and with ``pallas_dataplane="off"``, (c) fixed stripes with
   whole prefill, (d) a pool of 160 blocks, which cannot hold both long
   prompts.  Gates: every request gives 16 in-vocab tokens; (a) = (b);
   each long prompt's last-chunk logits against (c)'s whole prefill at
   cosine > 0.99; a prefill inserted or chunk-scattered into the pool
   gathers back bit for bit as the stripe holds it; (d) preempts and
   restores at least once and returns every block; flash launches 26 per
   whole prefill and none per chunk, chunk steps number sum(ceil(n /
   512)), and bounce launches on every chunk step and paged tick;
4. the same for hymba-1.5b at full width and depth (32 layers), which
   the engine prefills at exact prompt length: flash launches are 32 per
   prefill and ssm_scan launches 32 per prefill and per decode tick;
5a. the train path's kernels: (a) the flash kernel with its log-sum-exp
   against its plain version at the train shapes (B=2, S=256, gemma3
   heads, window 512 and global; lse within 2e-5 x max(1, |lse|), bf16
   output as phase 2 holds it), its time against ATen's flash attention
   (which also returns the lse); the QoS stall kernel returns ``x``
   itself with one launch and no stream sync (sync debug mode "error"),
   and its chain's slope is at least 1 ns an iteration;
5. training: full-width, full-depth gemma3-1b from seed 0 (f32
   parameters, bf16 compute) through ``make_explicit_dp_step`` on a mesh
   of 2 ranks on the card, global batch 4, seq 256, 3 steps, with
   ``benchmarks/converged.py``'s dataplane (cord, cost emulation,
   telemetry, the train tenant throttled by a QoS token bucket).  Gates:
   (b) the kernel forward against the plain forward inside the same
   autograd function from the same state: loss within 2e-2 relative,
   every synced gradient leaf at cosine > 0.99; (c) the runtime report:
   13 ops a step, the recorded bytes 3 x 4 x the parameter count (the
   float32 counter as the same adds give it), ``throttled`` as the port's
   CPU path gives it for the same ops, ``kernel_iters`` the sum of
   ``kernel_cost_totals``; (d) ``sync_grads`` under the sync debug mode
   "error"; (e) launches per step: flash with lse 26 x 2, bounce 2 x 13
   (cord's cost is on the send side only), stall 2 x 13.  It prints step
   wall ms, ``sync_grads`` ms, the psums' bounce time against
   ``torch.clone`` of the same payloads, and peak memory.

6a. the GSPMD step (``make_train_step``) on the same model through
   phase 5's dataplane on ``make_local_mesh()`` with ``activation_rules``
   for the train shape, so every edge of the loss crosses the bounce
   kernel: 3 steps with ``remat="none"`` at global batch 4, seq 256, then
   one step each with ``"full"`` and ``"dots"`` from the state before the
   third.  Gates: (a) the loss and all 13 gradients with the dataplane
   bit for bit those with ``dp=None``; (b) no gradient leaf zero or
   missing; (c) ``"full"`` and ``"dots"`` against ``"none"``: loss within
   1e-5 relative, every gradient at cosine > 0.9999; (d) one step's
   records the same (kind, tag) list in every mode; (e) launches per
   step in the forward and in the backward exactly
   ``_gspmd_launches``'s (bounce 186 forward; 1 backward, 183 with
   remat; flash with lse 26 forward, 26 more backward with remat; no
   stall); (f) step wall ms, one profiled step's device busy ms, peak
   memory per mode; the loss/logits edge's bounce (1.07 GB) against its
   plain version and ``torch.clone``, flash with lse at B=4;
6b. the launcher, ``repro_torch.launch.train.main(["--full", "steps=3",
   "seq_len=256", "global_batch=4", "checkpoint_every=2", ...])``, twice:
   the second resumes from the step-2 checkpoint (12 GB, written async)
   and its loss is the first run's third within 1e-6 relative; the
   checkpoint's bytes, write and restore ms;
6c. ``chunked_psum`` of a rank-stacked R=2 payload of ``embed/tok``'s
   size (2.42 GB) in 4 chunks under phase 5's QoS bucket, under the sync
   debug mode "error": bit for bit ``psum``'s, ``chunks`` and
   ``throttled`` as the CPU's, 8 bounce and 4 stall launches.

7a. the verbs transport (``core/verbs.py``) on a ``("rank",)`` mesh of 2
   ranks on the card through a cord dataplane with cost emulation:
   ``windowed_send`` of 64 messages, window 16, 64 credits: RC send /
   write / read at 64 KiB and 1 MiB, UD send at 4 KiB.  Gates: each
   delivery bit for bit the input; the QP and the runtime report equal
   to the same transfer on the CPU (its delay slope pinned to the
   card's) and with ``pallas_dataplane="off"``; bounce launches exactly
   64 (+ 1 for the receive grant of a send), nothing else launched; no
   stream sync in the loop (sync debug mode "error").  The synchronous
   path (16 posts, flush, poll) reports each rank's own state;
7b. the same RC send at 64 KiB under ``WireFault(drop_rate=0.1,
   corrupt_rate=0.05, seed=9)``: bit for bit the lossless run,
   retransmits > 0, the report as the CPU's, launches as the CPU run's
   delay chains count them; the port's hash against ``repro``'s schedule
   (``GOLDEN_*``); a transfer quiesced halfway, snapshotted (``repro``'s
   ring layout, checked row by row), restored into a fresh QP and
   finished, bit for bit the uninterrupted run; ``connection_churn`` at
   ``repro``'s defaults (13 rounds x 8 QPs x 4 messages of 256 B under the
   same loss), every round bit for bit; then bounce at one WR (4 KiB and
   1 MiB uint8 with cord's syscall chain) against its plain version and
   ``torch.clone``;
7c. perftest (``repro_torch.bench.perftest.run_all(fast=False)``): the
   calibration, fig1 over 64 B - 1 MiB, fig3 and fig5 at 4 KiB, fig4,
   the window sweep at 4 KiB and 64 KiB over windows 1-16, the credit
   ablation and the churn, each row printed; then 5 repetitions of
   fig3's BP->BP and CD->CD latencies with medians and spreads.  Two
   ranks share the card, so the "wire" is a device copy and a latency
   is not an RDMA latency: the claim is the relative-overhead structure.

8a. timelines on the serve path: phase 3's 8 requests on full-width
   gemma3-1b with ``Engine(..., obs=CounterTimeline(...))`` and without.
   Gates: identical tokens, one sample a decode tick holding the
   engine's counters, an artifact that validates, the same stream syncs
   (sync debug mode "warn") with the timeline and without; it prints the
   median tick ms of both and the host us of one ``snapshot_block`` and
   one ``ThresholdWatcher.observe`` (1,000 calls).  Then ``repro``'s
   exact-resume budget cycle under ``ServeElasticController``: 3
   requests of 8 tokens, 10 new each, ``max_batch=3``, shrink at tick 3,
   grow at tick 14; every request's tokens those of an undisturbed run,
   one shrink and one grow, the budget back at 3;
8b. the launcher with ``--timeline --timeline-sink --timeline-rotate
   --elastic`` at ``--ranks 4`` (global batch 4, seq 256, 6 steps, phase
   5's dataplane: cost emulation and a QoS bucket), metered by
   ``elastic.meter_quota_bytes`` under one step's psums: a trigger and a
   remesh to 2 ranks, then ``remesh-skipped`` for ``max_remesh``; bounce,
   stall and flash-with-lse launches per psum / layer follow the ranks
   (4 before the move, 2 after); every loss within 1e-4 relative of the
   same launcher at 4 ranks without the flags; the rotated sink read
   back equals the artifact.  Then 3 steps at 2 ranks with
   ``--timeline`` and 3 without: params and moments bit for bit; step
   ms on and off, one snapshot's ms with its device-to-host read, the
   stall's host us a call;
8c. ``bench.control_plane.control_plane_smoke`` (two 2-rank hosts, a
   WatcherGroup over the merged pod timeline, a QP migration there and
   back, a slot-budget shrink and grow) with host 1's engine on
   full-width gemma3-1b, and ``elastic_smoke``: ``repro``'s storyline,
   bit-identical migrated transfers, a validating pod artifact.

``--profile`` adds torch.profiler tables for one prefill of 256 tokens
and one 4-slot decode tick of each model.  The line before the last is
the per-kernel JSON summary; the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# bf16 flash kernel vs plain: one bf16 ulp of an output below 2 (2^-7)
# plus the rounding of P to bf16
FLASH_BF16_TOL = 1e-2
# ssm_scan kernel vs plain, f32: both compute in f32 with expf; the sum
# over N and fma contraction round differently
SSM_F32_TOL = 2e-5
SSM_FLOPS_PER_STATE_STEP = 6    # dt*a, exp, *h, dx*b, +, *c (+ reduction)


def _line(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, n: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _wall_ms(fn, n: int = 2) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls with no
    synchronisation between them: what the caller's thread spends to
    enqueue one call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / n


def _bits(t):
    import torch
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_build() -> str:
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    _line(card)
    _line(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all(("-Xptxas", "-v"))
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        _line(f"  nvcc {name}: {len(regs)} ptxas lines; "
              f"{regs[-1] if regs else 'cached'}")
        for ln in log.splitlines():   # e.g. serialised wgmma (C75xx)
            if "warning" in ln.lower() or "Performance" in ln:
                _line(f"    {ln.strip()}")
    _line(f"phase 0 build ok: {len(logs)} kernels in {secs:.1f} s")
    return card


# ---------------------------------------------------------------------------
# phase 1: dataplane bounce / cost kernel
# ---------------------------------------------------------------------------

def phase_bounce() -> dict:
    import torch
    from repro_torch.core import techniques as tech
    from repro_torch.kernels.dataplane import bounce as bk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    def payload(n, dtype):
        # a fresh payload for every call: an output block the allocator
        # hands back still holds the last call's bytes, which must not be
        # the right answer for this one
        if dtype.is_floating_point:
            x = torch.randn(n, generator=gen, device=dev).to(dtype)
            x[0] = float("nan")
            if n > 1:
                x[1] = -0.0
            return x
        return torch.randint(0, 120, (n,), generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    n_cases = 0
    # 401 chunks outnumber the grid (3 blocks per SM), so blocks take a
    # second turn of the grid-stride loop
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for n in (37, 1, 8193, 16384, 8192 * 400 + 37):
            for copies, delay in ((0, 5), (1, 0), (2, 37), (3, 0), (3, 999)):
                x = payload(n, dtype)
                got, gctr = bk.mediated_cost(x, delay, copies)
                want, wctr = bk.mediated_cost_plain(x, delay, copies)
                torch.cuda.synchronize()
                if not torch.equal(_bits(got), _bits(want)):
                    raise AssertionError(f"bounce bits differ: {dtype} n={n} "
                                         f"copies={copies} delay={delay}")
                if not torch.equal(gctr, wctr):
                    raise AssertionError(f"bounce counters differ: {dtype} "
                                         f"n={n} copies={copies}")
                if copies:
                    x = payload(n, dtype)
                    b = bk.bounce_copy(x, copies)
                    if not torch.equal(_bits(b), _bits(x)):
                        raise AssertionError("bounce_copy bits differ")
                n_cases += 1
        big_delay = 100_000
        x = payload(8192 * 400 + 37, dtype)
        got, gctr = bk.mediated_cost(x, big_delay, 1)
        want, wctr = bk.mediated_cost_plain(x, big_delay, 1)
        torch.cuda.synchronize()
        if not (torch.equal(_bits(got), _bits(want))
                and torch.equal(gctr, wctr)):
            raise AssertionError(f"bounce large delay differs: {dtype}")
        n_cases += 1
    x = torch.ones(8, device=dev)
    if bk.bounce_copy(x, 0) is not x or bk.mediated_cost(x, 0, 0)[0] is not x:
        raise AssertionError("bounce shortcuts lost")

    # the ring's edges: payloads at storage offsets of 0-15 bytes (an
    # unaligned head and tail, or, past offset 0, x and out disagreeing
    # modulo 16), sizes at 16 k +- 1, at the ring tile +- 1 (the smallest
    # tile, and the largest over every SM) and more tiles than the grid
    # has blocks times stages; bits and counters exact
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    big = sms * bk.RING_TILE_MAX
    sizes = [16 * k + d for k in (1, 7, 1000) for d in (-1, 1)]
    sizes += [t + d for t in (bk.RING_TILE_MIN, big) for d in (-1, 1)]
    sizes += [2 * big * bk.RING_STAGES + 37]
    n_ring = 0
    for nbytes in sizes:
        base = torch.randint(0, 256, (nbytes + 16,), generator=gen,
                             device=dev, dtype=torch.uint8)
        for off in (0, 1, 4, 8, 15):
            x = base[off:off + nbytes]
            for copies, delay in ((1, 0), (2, 37), (0, 5)):
                got, gctr = bk.mediated_cost(x, delay, copies)
                want, wctr = bk.mediated_cost_plain(x, delay, copies)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(gctr, wctr)):
                    tile, n_tiles, grid = bk.ring_plan(nbytes, sms, off)
                    raise AssertionError(
                        f"bounce ring case differs: {nbytes} bytes at offset "
                        f"{off}, copies={copies} delay={delay} (tile {tile}, "
                        f"{n_tiles} tiles, grid {grid})")
                n_ring += 1
        del base, x, got, want
    tile, n_tiles, grid = bk.ring_plan(sizes[-1], sms)
    if n_tiles <= grid * bk.RING_STAGES:
        raise AssertionError("no ring case has more tiles than grid x stages")

    ns = tech.calibrate(device=dev)
    if ns < 1.0:
        # one fma's latency alone is 4 cycles, about 2 ns: a slope below
        # 1 ns means the chain was cut or deleted
        raise AssertionError(f"delay chain slope {ns:.4f} ns/iteration < 1: "
                             f"the chain does not run in full")
    iters = tech.iters_for_ns(400.0, device=dev)      # cord's syscall cost
    res = {"cases": n_cases, "ring_cases": n_ring, "ns_per_iter": ns,
           "syscall_iters": iters, "sms": sms}
    # the payloads the main path sends through a cord edge: the f32
    # embedding table (36,864 chunks), a bf16 prefill activation, and a
    # small one; each held bit for bit against the plain version
    worst = 0.0
    for label, shape, dtype in (
            ("table_1.21GB", (262_144, 1152), torch.float32),
            ("act_1x512x1152_bf16", (1, 512, 1152), torch.bfloat16),
            ("64KB", (16_384,), torch.float32)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got, gctr = bk.mediated_cost(x, iters, 0)
        want, wctr = bk.mediated_cost_plain(x, iters, 0)
        torch.cuda.synchronize()
        if not (torch.equal(_bits(got), _bits(want))
                and torch.equal(gctr, wctr)):
            raise AssertionError(f"bounce {label}: output or counters "
                                 f"differ from the plain version")
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        del got, want
        nbytes = x.numel() * x.element_size()
        call = lambda: bk.mediated_cost(x, iters, 0)  # noqa: E731
        clone = lambda: torch.clone(x)                # noqa: E731
        ms = _cuda_ms(call, n=10)
        lib = _cuda_ms(clone, n=10)
        dev_ms = _device_ms(call, n=10)
        lib_dev = _device_ms(clone, n=10)
        plain = _wall_ms(lambda: bk.mediated_cost_plain(x, iters, 0), n=2)
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        chunks = int(gctr.shape[0])
        # the same chain alone: a 256-element payload, one chunk, at this
        # payload's total iterations
        chain = torch.zeros(256, device=dev)
        total_iters = chunks * -(-iters // chunks)
        chain_dev = _device_ms(lambda: bk.mediated_cost(chain, total_iters, 0),
                               n=10)
        row = {"bytes": nbytes, "chunks": chunks, "max_abs_err": err,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
               "library_ms": lib, "library_device_ms": lib_dev,
               "bound_ms": bound, "chain_iters": total_iters,
               "chain_device_ms": chain_dev,
               "tile_plan": list(bk.ring_plan(nbytes, sms))}
        if label != "table_1.21GB":
            row["host_us"] = _host_us(call)
            row["library_host_us"] = _host_us(clone)
        res[label] = row
        fmt = lambda v: "n/a" if v is None else f"{v:.4f} ms"  # noqa: E731
        _line(f"  bounce {label}: bit-exact over {chunks} chunks "
              f"(max |err| {err}), {ms:.4f} ms, device {fmt(dev_ms)} (bound "
              f"{bound:.4f} ms), torch.clone {lib:.4f} ms, device "
              f"{fmt(lib_dev)}; chain alone ({total_iters} iters) device "
              f"{fmt(chain_dev)}; plain {plain:.2f} ms"
              + (f"; host {row['host_us']:.2f} us/call, clone "
                 f"{row['library_host_us']:.2f} us/call"
                 if "host_us" in row else ""))
        del x
    res["max_abs_err"] = worst
    _line(f"phase 1 bounce ok: {n_cases} cases, {n_ring} ring-edge cases and "
          f"3 main-path payloads bit-exact, counters exact; calibrated "
          f"{ns:.4f} ns/iter ({iters} iters per 400 ns syscall)")
    return res


# ---------------------------------------------------------------------------
# phase 2: flash attention
# ---------------------------------------------------------------------------

def _pairs(sq: int, skv: int, window: int, valid: int) -> int:
    import numpy as np
    q = np.arange(sq)
    hi = np.minimum(q, min(valid, skv) - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _device_ms(fn, n: int = 20, tries: int = 3):
    """Device time per call of ``fn``: the card's kernel time that
    torch.profiler records over ``n`` calls, over ``n``.  The profiler
    sometimes loses kernel events, so a capture counts only when it holds
    every kernel of a one-call capture exactly ``n`` times as often; up to
    ``tries`` pairs of captures are made.  None when none was whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def capture(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        return events, {e.key: e.count for e in events
                        if e.device_type == DeviceType.CUDA}

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        _, once = capture(1)
        events, counts = capture(n)
        if once and counts == {k: c * n for k, c in once.items()}:
            return _kernel_us(events) / 1e3 / n
    return None


def _kernel_us(events) -> float:
    """Microseconds of device kernels among profiler events.  An aten op's
    self device time repeats its kernels' time, so only the device's own
    events count."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA)


def phase_flash() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B = 1
    # (model, dtype, H, KVH, D, S, window, valid_len, logit_cap)
    gemma = ("gemma3-1b", torch.bfloat16, 4, 1, 256)
    hymba = ("hymba-1.5b", torch.bfloat16, 25, 5, 64)    # GQA group of 5
    cases = [gemma + (s, w, None, 0.0) for s in (512, 2048) for w in (0, 512)]
    cases += [gemma + (2048, 0, 1500, 0.0), gemma + (512, 512, None, 50.0),
              gemma + (300, 0, None, 0.0),
              hymba + (300, 1024, None, 0.0), hymba + (2048, 1024, None, 0.0)]
    # the main path's own prefill shapes (gemma3 buckets, hymba exact)
    cases += [gemma + (s, 512, None, 0.0) for s in (16, 64, 256)]
    cases += [hymba + (s, 1024, None, 0.0) for s in (16, 77, 200)]
    # shapes that cut the kernel's 64-row tiles: a window that is no
    # multiple of 64, one query, no valid key (every row 0), valid_len
    # inside a tile
    cases += [gemma + (512, 100, None, 0.0), gemma + (1, 0, None, 0.0),
              gemma + (512, 0, 0, 0.0), gemma + (512, 0, 130, 0.0)]
    # the other head dims the wrapper takes in bf16 (16 and 32 padded to
    # 64), and the f32 CUDA-core path
    cases += [("bf16-d128", torch.bfloat16, 4, 2, 128, 300, 0, None, 0.0),
              ("bf16-d32", torch.bfloat16, 4, 2, 32, 200, 8, None, 0.0),
              ("bf16-d16", torch.bfloat16, 4, 1, 16, 200, 8, None, 0.0),
              ("f32", torch.float32, 4, 1, 16, 200, 8, None, 0.0)]
    rows, worst, map_ns, host_us, sdpa_host_us = [], 0.0, None, None, None
    for model, dtype, H, KVH, d, s, window, valid, cap in cases:
        # logits of std 3 put each row's weight on a few keys, so every
        # output row is O(1) and a lost or mis-scaled kv tile moves it by
        # O(1); values in [-1.5, 1.5) keep |o| < 2, where a bf16 ulp is
        # 2^-7 < FLASH_BF16_TOL
        q = (3 * torch.randn(B, s, H, d, generator=gen, device=dev)
             ).to(dtype)
        k = torch.randn(B, s, KVH, d, generator=gen, device=dev).to(dtype)
        v = (torch.rand(B, s, KVH, d, generator=gen, device=dev) * 3 - 1.5
             ).to(dtype)
        kw = dict(window=window, valid_len=valid, logit_cap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rms = want.float().pow(2).mean().sqrt().item()
        tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else 2e-5
        if valid == 0:
            # nothing to attend to: every row is exactly 0
            ok = bool((got == 0).all()) and bool((want == 0).all())
        else:
            ok = math.isfinite(err) and err <= tol and rms >= 0.3
        if not ok:
            raise AssertionError(f"flash error {err} > {tol} (or reference "
                                 f"rms {rms} < 0.3, or valid_len 0 not all "
                                 f"zero): {model} {dtype} H={H} KVH={KVH} "
                                 f"d={d} s={s} window={window} "
                                 f"valid={valid}")
        worst = max(worst, err) if dtype == torch.bfloat16 else worst
        vl = s if valid is None else valid
        flops = 4 * d * H * B * _pairs(s, s, window, vl)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        ms = _cuda_ms(call, n=20)
        dev_ms = _device_ms(call, n=20)
        plain = _cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), n=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kt = kt.repeat_interleave(H // KVH, dim=1)
        vt = vt.repeat_interleave(H // KVH, dim=1)
        lib_call = None
        if window == 0 and valid is None and cap == 0.0:
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
        elif cap == 0.0 and vl > 0:
            pos = torch.arange(s, device=dev)
            mask = (pos[None] <= pos[:, None]) & (pos[None] < vl)
            if window:
                mask &= pos[:, None] - pos[None] < window
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        # else no library call: none applies a tanh soft cap, and SDPA
        # gives NaN, not 0, for rows with no valid key
        lib = None if lib_call is None else _cuda_ms(lib_call, n=20)
        lib_dev = None if lib_call is None else _device_ms(lib_call, n=20)
        if model == "gemma3-1b" and s == 512 and window == 0 and \
                valid is None:
            map_ns = fa.tensor_map_ns(q, k, v)
            host_us = _host_us(call)
            sdpa_host_us = _host_us(lib_call)
        row = {"model": model, "dtype": str(dtype).replace("torch.", ""),
               "h": H, "kvh": KVH, "d": d, "s": s,
               "window": window, "valid_len": vl, "logit_cap": cap,
               "max_abs_err": err, "ref_rms": rms, "tol": tol, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain,
               "library_ms": lib, "library_device_ms": lib_dev,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rows.append(row)
        fmt = lambda x: "n/a" if x is None else f"{x:.4f} ms"  # noqa: E731
        share = "" if dev_ms is None else \
            f", {row['bound_ms'] / dev_ms:.1%} of bound"
        _line(f"  flash {model} {row['dtype']} H={H} KVH={KVH} d={d} s={s} "
              f"w={window} vl={vl} cap={cap}: err {err:.3g} (<= {tol}; "
              f"reference rms {rms:.3f}), {ms:.4f} ms, device "
              f"{fmt(dev_ms)}, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}{share}), sdpa {fmt(lib)}, device "
              f"{fmt(lib_dev)}, plain {plain:.3f} ms")
    _line(f"  flash host time: {host_us:.2f} us per call (1,000 calls, no "
          f"sync; SDPA {sdpa_host_us:.2f}), {map_ns / 1e3:.3f} us of it "
          f"encoding the 3 tensor maps (gemma3 S=512)")
    _line(f"phase 2 flash ok: {len(rows)} cases, worst bf16 error "
          f"{worst:.3g} <= {FLASH_BF16_TOL}")
    return {"cases": rows, "worst_bf16_err": worst, "tensor_map_ns": map_ns,
            "host_us": host_us, "library_host_us": sdpa_host_us}


# ---------------------------------------------------------------------------
# phase 2b: mamba selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(gen, shape, dtype, long_memory: bool = False):
    """dt, x, a, b, c, h0 on the card as tests/test_kernels.py makes them,
    with a nonzero h0: dt = softplus(N(0, 1)) and A = -exp(0.3 N(0, 1))
    decay h by about e^-1 a step, so y is O(1) and both h0 and every step
    move it by O(1).  ``long_memory`` takes mamba's own initialisation
    instead, dt log-uniform in [1e-3, 1e-1] and A = -(1..N) on every
    channel: the state then lasts tens to hundreds of steps, across the
    kernel's time chunks, so an error in the carry between chunks shows.
    dt and x in ``dtype``; b and c are rounded to it and kept in f32, as
    the kernel takes them."""
    import torch
    import torch.nn.functional as F
    bsz, s, di, n = shape
    dev = torch.device("cuda")
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    if long_memory:
        u = torch.rand(bsz, s, di, generator=gen, device=dev)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0)).to(dtype)
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
    else:
        dt = F.softplus(rnd(bsz, s, di)).to(dtype)
        a = -torch.exp(rnd(di, n) * 0.3)
    x = rnd(bsz, s, di).to(dtype)
    b = rnd(bsz, s, n).to(dtype).float()
    c = rnd(bsz, s, n).to(dtype).float()
    h0 = rnd(bsz, di, n)
    return dt, x, a, b, c, h0


def _ssm_bound(shape, dtype_bytes: int) -> tuple[int, int, float, str]:
    """(bytes, flops, bound ms, what bounds it) of one scan: dt, x and y
    once each, b, c, a, h0 and h_final in f32."""
    bsz, s, di, n = shape
    nbytes = 3 * bsz * s * di * dtype_bytes + 4 * (
        2 * bsz * s * n + di * n + 2 * bsz * di * n)
    flops = SSM_FLOPS_PER_STATE_STEP * bsz * s * di * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return nbytes, flops, max(t_bytes, t_ops), \
        "operations" if t_ops > t_bytes else "bytes"


def phase_ssm() -> dict:
    import torch
    from repro_torch.kernels.ssm_scan import ops as ssm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    di, n = 3200, 16                   # hymba-1.5b: d_inner, state size
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # prefill lengths that cross the chunk plan: one chunk (1, 16, 31),
    # two (37), a ragged last chunk (300: 18 chunks of 17, the last 11),
    # long sequences (2048, 4096), state that outlives a chunk, a batch of
    # 4, and the 4-slot decode tick
    cases = [("prefill", (1, s, di, n), torch.float32)
             for s in (1, 16, 31, 37, 300, 2048, 4096)]
    cases += [("prefill_long_memory", (1, s, di, n), torch.float32)
              for s in (300, 2048)]
    cases += [("prefill_b4", (4, 300, di, n), torch.float32),
              ("decode", (4, 1, di, n), torch.float32),
              ("prefill", (1, 300, di, n), torch.bfloat16),
              ("ragged_di", (2, 37, 200, n), torch.float32)]
    rows, worst = [], 0.0
    for label, shape, dtype in cases:
        args = _ssm_inputs(gen, shape, dtype,
                           long_memory=label == "prefill_long_memory")
        y, hf = ssm.ssm_scan(*args)
        yp, hp = ssm.ssm_scan_plain(*args)
        torch.cuda.synchronize()
        yf, ypf = y.float(), yp.float()
        ref_max = ypf.abs().max().item()
        lim_y = SSM_F32_TOL * ypf.abs().clamp(min=1.0)
        if dtype == torch.bfloat16:
            # one bf16 ulp of the output on top of the f32 limit
            lim_y = lim_y + torch.exp2(torch.floor(torch.log2(
                torch.maximum(yf.abs(), ypf.abs()).clamp(min=2.0 ** -126))) - 7)
        err_y = (yf - ypf).abs()
        err_h = (hf - hp).abs()
        lim_h = SSM_F32_TOL * hp.abs().clamp(min=1.0)
        ok = (bool((err_y <= lim_y).all()) and bool((err_h <= lim_h).all())
              and math.isfinite(err_y.max().item()) and ref_max >= 1.0)
        err = max(err_y.max().item(), err_h.max().item())
        bsz, s, d_in, _ = shape
        chunk_len, n_chunks = ssm.chunk_plan(bsz, s, d_in, sms)
        if not ok:
            raise AssertionError(
                f"ssm_scan {label} {tuple(shape)} {dtype}: y error "
                f"{err_y.max().item()}, h_final error {err_h.max().item()} "
                f"above 2e-5 * max(1, |ref|) (bf16: + one ulp), or reference "
                f"max |y| {ref_max} < 1 ({n_chunks} chunks of {chunk_len})")
        if dtype == torch.float32:
            worst = max(worst, err)
        nbytes, flops, bound, bound_by = _ssm_bound(shape, y.element_size())
        call = lambda: ssm.ssm_scan(*args)  # noqa: E731
        ms = _cuda_ms(call, n=20)
        dev_ms = _device_ms(call, n=20)
        plain = _cuda_ms(lambda: ssm.ssm_scan_plain(*args), n=2, warmup=1)
        row = {"label": label, "shape": list(shape),
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
               "ref_max_abs": ref_max, "chunk_len": chunk_len,
               "n_chunks": n_chunks, "cuda_launches": 1 if n_chunks == 1 else 3,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
               "library_ms": None, "bytes": nbytes, "flops": flops,
               "bound_ms": bound, "bound_by": bound_by}
        if label == "decode":
            row["host_us"] = _host_us(call)
        rows.append(row)
        share = "" if dev_ms is None else f", {bound / dev_ms:.1%} of bound"
        dev_txt = "n/a" if dev_ms is None else f"{dev_ms:.4f} ms"
        _line(f"  ssm_scan {label} {tuple(shape)} {row['dtype']}: err "
              f"{err:.3g} (max |ref| {ref_max:.2f}), {n_chunks} chunks of "
              f"{chunk_len}, {ms:.4f} ms, device {dev_txt}, bound "
              f"{bound:.4f} ms ({bound_by}{share}), plain {plain:.3f} ms"
              + (f"; host {row['host_us']:.2f} us/call"
                 if "host_us" in row else ""))
    _line(f"phase 2b ssm_scan ok: {len(rows)} cases, worst f32 error "
          f"{worst:.3g} (limit 2e-5 * max(1, |ref|))")
    return {"cases": rows, "worst_f32_err": worst}


# ---------------------------------------------------------------------------
# phases 3 and 4: serving at full width through the CoRD dataplane
# ---------------------------------------------------------------------------

def _kernel_modules() -> dict:
    """name -> wrapper module of every kernel (each has ``LAUNCHES``)."""
    from repro_torch.kernels.dataplane import bounce, stall
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as ssm
    return {"bounce": bounce, "flash_attention": flash, "ssm_scan": ssm,
            "bounce_stall": stall}


def _launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def _reset_launches() -> None:
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _timed_model(model, stats):
    """The model with prefill / prefill chunk / slot decode timed
    (synchronised) and the kernel launches of each call counted.  With a
    ``"logits"`` dict in ``stats``, the logits that a whole prefill or a
    prompt's last chunk gives are kept by ``last_pos``."""
    import dataclasses

    import torch

    def keep(last_pos, lo, hi, logits):
        if "logits" in stats and last_pos is not None:
            last = int(last_pos.reshape(-1)[0])
            if lo <= last < hi:
                stats["logits"][last] = logits[0, -1].float().clone()

    def prefill(params, batch, cache, **kw):
        torch.cuda.synchronize()
        n0, t0 = _launches(), time.perf_counter()
        out = model.prefill(params, batch, cache, **kw)
        torch.cuda.synchronize()
        s = batch["tokens"].shape[1]
        stats["prefill"].append((s, (time.perf_counter() - t0) * 1e3,
                                 _delta(n0)))
        keep(kw.get("last_pos"), 0, s, out[0])
        return out

    def chunk(params, batch, cache, offset, **kw):
        torch.cuda.synchronize()
        n0, t0 = _launches(), time.perf_counter()
        out = model.prefill_chunk(params, batch, cache, offset, **kw)
        torch.cuda.synchronize()
        c = batch["tokens"].shape[1]
        stats.setdefault("chunk", []).append(
            (offset, (time.perf_counter() - t0) * 1e3, _delta(n0)))
        keep(kw.get("last_pos"), offset, offset + c, out[0])
        return out

    def decode(params, token, cache, pos, **kw):
        torch.cuda.synchronize()
        n0, t0 = _launches(), time.perf_counter()
        out = model.decode_step_slots(params, token, cache, pos, **kw)
        torch.cuda.synchronize()
        stats["decode"].append(((time.perf_counter() - t0) * 1e3,
                                _delta(n0)))
        return out

    return dataclasses.replace(
        model, prefill=prefill, decode_step_slots=decode,
        prefill_chunk=chunk if model.prefill_chunk is not None else None)


def _per_call(rows, name) -> list[int]:
    return sorted({launches[name] for launches in rows})


def phase_serve(arch: str, phase: str) -> dict:
    """Serve 8 requests on ``arch`` at full width through a cord
    dataplane and hold every gate; see the module docstring."""
    import numpy as np
    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import DataplaneConfig, ServeConfig
    from repro_torch.core import Dataplane
    from repro_torch.kernels.dataplane import bounce as bk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, Request

    cfg = get_model_config(arch)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _line(f"  {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B f32 params "
          f"initialised in {time.perf_counter() - t0:.1f} s"
          f"{'; prefilled at exact length' if model.recurrent else ''}")
    mesh = make_mesh((1,), ("data",))

    def dataplane(**kw):
        return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True,
                                         **kw),
                         mesh=mesh, tenant="alice", tenants=("alice", "bob"))

    # no mesh, or no cost emulation: no dataplane kernel runs
    toks = torch.arange(16, device="cuda")[None]
    for dp in (Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                         tenant="alice"),
               Dataplane(DataplaneConfig(mode="cord"), mesh=mesh,
                         tenant="alice")):
        n0 = bk.LAUNCHES
        model.prefill(params, {"tokens": toks}, model.init_cache(1, 16),
                      dp=dp)
        torch.cuda.synchronize()
        if bk.LAUNCHES != n0:
            raise AssertionError("a dataplane kernel ran without mesh + "
                                 "emulate_costs")

    # small-input reference: the last prompt position's logits from the
    # flash prefill equal those from a prefill one token shorter followed
    # by one plain-attention decode step (for hymba also a one-step scan
    # from the prefill's h_final)
    dp = dataplane()
    seq = torch.randint(0, cfg.vocab_size, (1, 33), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    ref, _ = model.prefill(params, {"tokens": seq}, model.init_cache(1, 33),
                           dp=dp)
    cache = model.init_cache(1, 40)
    model.prefill(params, {"tokens": seq[:, :32]}, cache, dp=dp)
    alt, _ = model.decode_step_slots(params, seq[:, 32:], cache,
                                     torch.tensor([32], device="cuda"), dp=dp)
    a, b = ref[0, -1].float(), alt[0, -1].float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()
            and cos > 0.99):
        raise AssertionError(f"prefill vs decode logits disagree: cos {cos}")
    _line(f"  prefill(33) vs prefill(32)+decode logits: cosine {cos:.5f}, "
          f"max |diff| {(a - b).abs().max().item():.4f} of max |logit| "
          f"{a.abs().max().item():.3f}")

    rng = np.random.default_rng(0)
    lengths = (16, 300, 40, 129, 77, 256, 24, 200)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    scfg = ServeConfig(max_batch=4, kv_cache_len=640, max_new_tokens=16)

    def serve(dp, stats):
        eng = Engine(_timed_model(model, stats), params, cfg, scfg, dp=dp,
                     eos_id=-1)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        tenant=("alice", "bob")[i % 2])
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != len(prompts) or not all(r.done for r in done):
            raise AssertionError("not every request finished")
        for r in done:
            if len(r.out_tokens) != 16 or not all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise AssertionError(f"request {r.rid}: bad tokens")
        tokens = {r.rid: list(r.out_tokens) for r in done}
        ttft = [r.t_first - t0 for r in done]
        return tokens, wall, ttft, eng

    dp = dataplane()
    stats = {"prefill": [], "decode": []}
    _reset_launches()
    tokens, wall, ttft, eng = serve(dp, stats)
    launches = _launches()
    n_prefill, n_tick = len(stats["prefill"]), len(stats["decode"])
    want = {"flash_attention": cfg.num_layers * n_prefill,
            "ssm_scan": (cfg.num_layers * (n_prefill + n_tick)
                         if model.recurrent else 0)}
    if launches["bounce"] <= 0 or any(launches[k] != v
                                      for k, v in want.items()):
        raise AssertionError(f"main path launches {launches}, want {want} "
                             f"and bounce > 0 ({n_prefill} prefills, "
                             f"{n_tick} decode ticks)")
    if model.recurrent and sorted(s for s, _, _ in stats["prefill"]) != \
            sorted(lengths):
        raise AssertionError("a recurrent prefill was not at exact length")
    tokens2, _, _, _ = serve(dataplane(), {"prefill": [], "decode": []})
    if tokens2 != tokens:
        raise AssertionError("a second run gave other tokens")
    tokens_off, _, _, _ = serve(dataplane(pallas_dataplane="off"),
                                {"prefill": [], "decode": []})
    if tokens_off != tokens:
        raise AssertionError("cuda-on and off gave other tokens")

    n_tok = sum(len(t) for t in tokens.values())
    by_len: dict[int, list[float]] = {}
    for s, ms, _ in stats["prefill"]:
        by_len.setdefault(s, []).append(ms)
    dec_ms = [ms for ms, _ in stats["decode"]]
    pre_l = [d for _, _, d in stats["prefill"]]
    dec_l = [d for _, d in stats["decode"]]
    res = {
        "arch": arch, "requests": len(tokens), "tokens": n_tok,
        "wall_s": wall, "tok_per_s": n_tok / wall,
        "ttft_ms_mean": 1e3 * float(np.mean(ttft)),
        "ttft_ms_max": 1e3 * float(np.max(ttft)),
        "prefill_ms_by_len": {str(s): v for s, v in sorted(by_len.items())},
        "decode_ticks": n_tick, "decode_ms_mean": float(np.mean(dec_ms)),
        "decode_ms_median": float(np.median(dec_ms)),
        "launches": launches, "prefills": n_prefill,
        "launches_per_prefill": {k: _per_call(pre_l, k) for k in launches},
        "launches_per_tick": {k: _per_call(dec_l, k) for k in launches},
        "tenant_report": eng.tenant_report(),
        "dataplane_ops": dp.telemetry.by_kind(),
    }
    per_len = ", ".join(f"{s}: {np.mean(v):.1f}" for s, v in sorted(by_len.items()))
    _line(f"  prefill ms by length {{{per_len}}}")
    _line(f"  decode {n_tick} ticks, {res['decode_ms_mean']:.2f} ms/tick "
          f"mean ({res['decode_ms_median']:.2f} median); {n_tok} tokens in "
          f"{wall:.2f} s = {res['tok_per_s']:.1f} tok/s; TTFT mean "
          f"{res['ttft_ms_mean']:.0f} ms, max {res['ttft_ms_max']:.0f} ms")
    _line(f"  launches {launches}; per prefill "
          f"{res['launches_per_prefill']}, per decode tick "
          f"{res['launches_per_tick']}")
    _line(f"phase {phase} serve {arch} ok: {len(tokens)} requests finished, "
          f"tokens identical on repeat and with pallas_dataplane=off")
    res["_profile_inputs"] = (model, params, dataplane, prompts)
    return res


# phase 3c: the paged KV pool and chunked prefill on gemma3-1b
LONG_PROMPTS = (1100, 2000)     # 3 and 4 chunks of 512
CHUNK = 512                     # repro's default ServeConfig.prefill_chunk
BLOCK = 16


def _check_paged_movement(model, params, pool_blocks: int, kv_len: int):
    """Gate 4: the pool helpers move a prefill's cache exactly.  One whole
    prefill (300 tokens, cover 512) is inserted and one chunked prefill
    (2000 tokens, 4 chunks) is scattered chunk by chunk into a pool of the
    paged run's geometry, at block ids scattered by earlier frees; the
    gathered rows [0:eff] of each slot must equal, bit for bit, the stripe
    rows that the fixed path's slot insert writes from the same prefill."""
    import numpy as np
    import torch
    from repro_torch.layers import kvcache as kv

    spec = model.init_cache(1, BLOCK)
    layers, _, _, kvh, hd = spec["k"].shape
    pool = kv.kv_pool_init(layers, pool_blocks, BLOCK, kvh, hd,
                           dtype=spec["k"].dtype, device="cuda")
    stripe = model.init_cache(4, kv_len)
    alloc = kv.BlockAllocator(pool_blocks)
    held = [alloc.alloc(n) for n in (7, 50, 3, 90)]
    alloc.free(held[1])
    alloc.free(held[3])
    tables = np.zeros((4, pool_blocks), np.int32)
    gen = np.random.default_rng(5)
    rows = 0
    for slot, (n, chunked) in ((2, (300, False)), (1, (2000, True))):
        cover = -(-n // CHUNK) * CHUNK if chunked else 512
        ids = alloc.alloc(cover // BLOCK)
        tables[slot, :len(ids)] = ids
        toks = torch.zeros((1, cover), dtype=torch.long, device="cuda")
        toks[0, :n] = torch.as_tensor(gen.integers(0, model.cfg.vocab_size,
                                                   n), device="cuda")
        pc = model.init_cache(1, cover)
        last = torch.tensor([n - 1], device="cuda")
        if chunked:
            for off in range(0, cover, CHUNK):
                _, pc = model.prefill_chunk(
                    params, {"tokens": toks[:, off:off + CHUNK]}, pc, off,
                    last_pos=last)
                kv.kv_pool_scatter_chunk(pool, pc, tables[slot], off, CHUNK,
                                         BLOCK)
        else:
            _, pc = model.prefill(params, {"tokens": toks}, pc,
                                  last_pos=last)
            kv.kv_pool_insert(pool, pc, ids, BLOCK)
        kv.state_slot_insert(stripe, pc, slot)
        dense = kv.kv_pool_gather(pool, tables, BLOCK)
        for name in ("k", "v"):
            got = dense[name][:, slot, :n]
            want = stripe[name][:, slot, :n]
            if not torch.equal(_bits(got), _bits(want)):
                raise AssertionError(f"paged {name} rows of the {n}-token "
                                     f"prefill differ from the stripe's")
        rows += n
        del dense, pc
    if pool["k"][:, 0].any() or pool["v"][:, 0].any():
        raise AssertionError("the null block was written")
    return rows


def phase_serve_paged(model, params, dataplane, prompts8) -> dict:
    """Serve gemma3-1b at full width from the paged KV pool with chunked
    prefill through a cord dataplane, and hold every gate; see the module
    docstring."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import Engine, Request
    from repro_torch.serve import engine as engine_mod

    cfg = model.cfg
    rng = np.random.default_rng(1)
    longs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in LONG_PROMPTS]
    # the long prompts between phase 3's: under the pressure run's pool
    # the 2000-token prompt's chunked prefill forces a preemption
    prompts = [prompts8[0], longs[0], prompts8[1], longs[1], *prompts8[2:]]
    short = {0, 2, 4, 5, 6, 7, 8, 9}                  # rids of phase 3's 8
    base = dict(max_batch=4, kv_cache_len=2560, max_new_tokens=16)

    gather_ms = []
    orig_gather = engine_mod.kv_pool_gather

    def timed_gather(pool, tables, bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_gather(pool, tables, bs)
        torch.cuda.synchronize()
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def serve(dp, stats, **serve_kw):
        eng = Engine(_timed_model(model, stats), params, cfg,
                     ServeConfig(**base, **serve_kw), dp=dp, eos_id=-1)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        tenant=("alice", "bob")[i % 2])
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != len(prompts) or not all(r.done for r in done):
            raise AssertionError("not every request finished")
        for r in done:
            if len(r.out_tokens) != 16 or not all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise AssertionError(f"request {r.rid}: bad tokens")
        ttft = {r.rid: (r.t_first - t0) * 1e3 for r in done}
        return {r.rid: list(r.out_tokens) for r in done}, wall, ttft, eng

    def fresh():
        return {"prefill": [], "decode": [], "chunk": [], "logits": {}}

    paged = dict(block_size=BLOCK, prefill_chunk=CHUNK)
    engine_mod.kv_pool_gather = timed_gather
    try:
        stats_a = fresh()
        _reset_launches()
        tok_a, wall_a, ttft_a, eng_a = serve(dataplane(), stats_a, **paged)
        launches = _launches()
        gather_a = list(gather_ms)
        tok_b, _, _, _ = serve(dataplane(), fresh(), **paged)
        tok_off, _, _, _ = serve(dataplane(pallas_dataplane="off"), fresh(),
                                 **paged)
        stats_d = fresh()
        tok_d, _, _, eng_d = serve(dataplane(), stats_d, n_blocks=160,
                                   **paged)
    finally:
        engine_mod.kv_pool_gather = orig_gather
    stats_c = fresh()
    tok_c, wall_c, ttft_c, _ = serve(dataplane(), stats_c, prefill_chunk=0)

    # gate 2: paged + chunked is deterministic, cuda-on and off alike
    if tok_b != tok_a or tok_off != tok_a:
        raise AssertionError("paged + chunked runs gave other tokens")
    # gate 3: the last chunk's logits against (c)'s whole prefill
    cos_rows = {}
    for n in LONG_PROMPTS:
        a, c = stats_a["logits"][n - 1], stats_c["logits"][n - 1]
        cos = F.cosine_similarity(a, c, dim=0).item()
        cos_rows[n] = {"cosine": cos,
                       "max_abs_diff": (a - c).abs().max().item(),
                       "max_abs_logit": c.abs().max().item()}
        if not (torch.isfinite(a).all() and cos > 0.99):
            raise AssertionError(f"chunked vs whole logits of the {n}-token "
                                 f"prompt disagree: cosine {cos}")
    # gate 4: exact data movement into and out of the pool
    moved = _check_paged_movement(model, params, eng_a._n_usable,
                                  base["kv_cache_len"])
    # gate 5: the pressure run preempts, restores and returns every block
    rep_d = eng_d.tenant_report()
    pre = sum(v["preemptions"] for v in rep_d.values())
    res = sum(v["restores"] for v in rep_d.values())
    if pre < 1 or res < 1:
        raise AssertionError(f"pressure run: {pre} preemptions, {res} "
                             f"restores; want >= 1 each")
    if eng_d._alloc.free_blocks != eng_d._n_usable or eng_d._tables.any():
        raise AssertionError("pressure run: blocks or table rows not "
                             "returned at the end")
    # gate 6: exact launch counts per step kind
    want_chunks = sum(-(-n // CHUNK) for n in LONG_PROMPTS)
    for name, st in (("a", stats_a), ("c", stats_c), ("d", stats_d)):
        pre_l = [d for _, _, d in st["prefill"]]
        if any(d["flash_attention"] != cfg.num_layers for d in pre_l):
            raise AssertionError(f"run {name}: flash launches per whole "
                                 f"prefill {_per_call(pre_l, 'flash_attention')}"
                                 f", want {cfg.num_layers}")
        chunk_l = [d for _, _, d in st["chunk"]]
        if any(d["flash_attention"] or d["bounce"] <= 0 for d in chunk_l):
            raise AssertionError(f"run {name}: a chunk step launched flash "
                                 f"or no bounce")
        if any(d["bounce"] <= 0 for _, d in st["decode"]):
            raise AssertionError(f"run {name}: a decode tick launched no "
                                 f"bounce")
    if len(stats_a["chunk"]) != want_chunks or stats_c["chunk"]:
        raise AssertionError(f"chunk steps: (a) {len(stats_a['chunk'])}, "
                             f"want {want_chunks}; (c) "
                             f"{len(stats_c['chunk'])}, want 0")
    n_whole = len(stats_a["prefill"])
    if launches["flash_attention"] != cfg.num_layers * n_whole or \
            n_whole != len(prompts) - len(LONG_PROMPTS) or \
            launches["bounce"] <= 0:
        raise AssertionError(f"paged run launches {launches} over {n_whole} "
                             f"whole prefills")

    def per_kind(st):
        return {"prefill": _per_call([d for _, _, d in st["prefill"]],
                                     "bounce"),
                "chunk": _per_call([d for _, _, d in st["chunk"]], "bounce"),
                "tick": _per_call([d for _, d in st["decode"]], "bounce")}

    n_tok = sum(len(t) for t in tok_a.values())
    same_ac = sum(tok_a[i] == tok_c[i] for i in tok_a)
    out = {
        "prompts": [len(p) for p in prompts],
        "tokens": n_tok, "wall_s": wall_a, "tok_per_s": n_tok / wall_a,
        "fixed_wall_s": wall_c, "fixed_tok_per_s": n_tok / wall_c,
        "ttft_short_ms": {
            "paged_chunked": {"mean": float(np.mean([ttft_a[i] for i in short])),
                              "max": float(np.max([ttft_a[i] for i in short]))},
            "fixed_whole": {"mean": float(np.mean([ttft_c[i] for i in short])),
                            "max": float(np.max([ttft_c[i] for i in short]))}},
        "decode_ticks": {"paged": len(stats_a["decode"]),
                         "fixed": len(stats_c["decode"])},
        "decode_ms_mean": {
            "paged": float(np.mean([ms for ms, _ in stats_a["decode"]])),
            "fixed": float(np.mean([ms for ms, _ in stats_c["decode"]]))},
        "gather_ms_mean": float(np.mean(gather_a)),
        "chunk_steps": len(stats_a["chunk"]),
        "chunk_ms_mean": float(np.mean([ms for _, ms, _ in stats_a["chunk"]])),
        "launches": launches,
        "bounce_per_step": {"paged_chunked": per_kind(stats_a),
                            "fixed_whole": per_kind(stats_c)},
        "chunked_vs_whole": cos_rows,
        "streams_equal_paged_chunked_vs_fixed_whole": same_ac,
        "pressure": {"preemptions": pre, "restores": res,
                     "n_blocks": eng_d._n_usable},
        "paged_rows_checked": moved,
        "n_usable_blocks": eng_a._n_usable,
    }
    tt = out["ttft_short_ms"]
    _line(f"  paged+chunked: {n_tok} tokens in {wall_a:.2f} s = "
          f"{out['tok_per_s']:.1f} tok/s ({out['fixed_tok_per_s']:.1f} fixed "
          f"whole); TTFT of the 8 short: mean {tt['paged_chunked']['mean']:.0f}"
          f" ms, max {tt['paged_chunked']['max']:.0f} ms (fixed whole "
          f"{tt['fixed_whole']['mean']:.0f} / {tt['fixed_whole']['max']:.0f})")
    _line(f"  decode ms/tick paged {out['decode_ms_mean']['paged']:.2f} "
          f"({out['decode_ticks']['paged']} ticks) vs fixed "
          f"{out['decode_ms_mean']['fixed']:.2f} "
          f"({out['decode_ticks']['fixed']}); gather "
          f"{out['gather_ms_mean']:.3f} ms/tick; {want_chunks} chunk steps "
          f"{out['chunk_ms_mean']:.2f} ms each")
    _line(f"  bounce launches per step: {out['bounce_per_step']}; launches "
          f"{launches}")
    _line("  chunked vs whole last logits: " + ", ".join(
        f"{n}: cosine {r['cosine']:.5f}, max |diff| {r['max_abs_diff']:.4f} "
        f"of {r['max_abs_logit']:.3f}" for n, r in cos_rows.items()))
    _line(f"  pressure run (160 blocks): {pre} preemptions, {res} restores, "
          f"every block returned; {moved} paged rows bit-exact against the "
          f"stripe; {same_ac}/{len(tok_a)} streams of paged+chunked equal "
          f"fixed+whole")
    _line(f"phase 3c serve gemma3-1b paged+chunked ok: {len(tok_a)} requests "
          f"x 5 runs, tokens identical on repeat and with "
          f"pallas_dataplane=off")
    return out


def profile_serve(model, params, dataplane, prompts) -> dict:
    """torch.profiler over one full-width prefill of 256 tokens and one
    4-slot decode tick through the cord dataplane: device and host time
    by operator.  A model with chunked prefill adds phase 3c's paged tick
    (gather from 640 blocks, the decode tick on the 4 x 10,240-position
    view, the token scatter) and a 512-token chunk at offset 1536 of a
    2048-position cache."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.layers import kvcache as kv

    dp = dataplane()
    toks = torch.as_tensor(prompts[5][None], dtype=torch.long, device="cuda")
    cache = model.init_cache(4, 640)
    tok = torch.full((4, 1), 7, dtype=torch.long, device="cuda")
    pos_np = np.asarray([256, 300, 40, 129], np.int32)
    pos = torch.as_tensor(pos_np, device="cuda")
    steps = [("prefill_256", lambda: model.prefill(
                  params, {"tokens": toks}, model.init_cache(1, 256), dp=dp)),
             ("decode_tick", lambda: model.decode_step_slots(
                  params, tok, cache, pos, dp=dp))]
    if model.prefill_chunk is not None:
        spec = model.init_cache(1, BLOCK)["k"]
        n_blocks = 4 * 2560 // BLOCK
        pool = kv.kv_pool_init(spec.shape[0], n_blocks, BLOCK, spec.shape[3],
                               spec.shape[4], dtype=spec.dtype, device="cuda")
        tables = np.zeros((4, n_blocks), np.int32)
        for i, p in enumerate(pos_np):
            nb = int(p) // BLOCK + 1
            tables[i, :nb] = np.arange(1, nb + 1) + 40 * i
        active = np.ones(4, bool)
        chunk_toks = toks[:, :1].repeat(1, CHUNK)
        chunk_cache = model.init_cache(1, 2048)

        def paged_tick():
            dense = kv.kv_pool_gather(pool, tables, BLOCK)
            _, dense = model.decode_step_slots(params, tok, dense, pos, dp=dp)
            kv.kv_pool_scatter_token(pool, dense, tables, pos_np, active,
                                     BLOCK)

        steps += [("paged_tick", paged_tick),
                  ("chunk_512_at_1536", lambda: model.prefill_chunk(
                      params, {"tokens": chunk_toks},
                      kv.kv_cache_constrain(dp, chunk_cache), 1536, dp=dp))]
    out = {}
    for name, fn in steps:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        dev_total = _kernel_us(ev) / 1e3
        by_dev = sorted(ev, key=lambda e: -e.self_device_time_total)[:15]
        by_cpu = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:15]
        ours = [(e.key, e.count, e.self_device_time_total / 1e3) for e in ev
                if any(k in e.key for k in ("bounce_kernel", "flash_fwd",
                                            "ssm_scan_kernel",
                                            "ssm_chunk_state", "ssm_carry"))]
        out[name] = {
            "wall_ms": wall, "device_ms": dev_total,
            "device_idle_share": max(0.0, 1 - dev_total / wall),
            "port_kernels": ours,
            "top_device": [(e.key, e.count, e.self_device_time_total / 1e3)
                           for e in by_dev],
            "top_host": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in by_cpu],
        }
        _line(f"  profile {model.cfg.name} {name}: wall {wall:.2f} ms, "
              f"device busy {dev_total:.2f} ms")
        for key, count, ms in out[name]["top_device"][:8]:
            _line(f"    device {ms:8.3f} ms {count:5d}x {key[:70]}")
        for key, count, ms in out[name]["top_host"][:6]:
            _line(f"    host   {ms:8.3f} ms {count:5d}x {key[:70]}")
        for key, count, ms in ours:
            _line(f"    port kernel {ms:8.3f} ms {count:5d}x {key[:60]}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the explicit-DP train step at full width through the dataplane
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_RANKS = 2          # mesh ("data",) of 2 ranks on the one card
TRAIN_BATCH = 4          # global batch: 2 sequences a rank
TRAIN_SEQ = 256
TRAIN_STEPS = 3
TRAIN_TENANTS = ("train", "alice", "bob")
# f32 lse, kernel vs plain: both take the same bf16 products in f32; the
# sums run in another order and the kernel works in base 2
LSE_TOL = 2e-5
TRAIN_LOSS_RTOL = 2e-2   # kernel vs plain forward inside the same function
TRAIN_GRAD_COS = 0.99


def _train_dataplane(dev, mesh=None, rules=None):
    """``benchmarks/converged.py``'s dataplane: cord with cost emulation,
    telemetry, and the train tenant rate-limited by a QoS token bucket;
    on a ``("data",)`` mesh of TRAIN_RANKS ranks unless ``mesh`` is
    given."""
    from repro_torch.configs.base import DataplaneConfig
    from repro_torch.core import Dataplane, QoSPolicy, TelemetryPolicy
    from repro_torch.launch.mesh import make_mesh
    return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                     mesh=mesh or make_mesh((TRAIN_RANKS,), ("data",)),
                     rules=rules, tenant="train", tenants=TRAIN_TENANTS,
                     policies=[TelemetryPolicy(),
                               QoSPolicy(rates={"train": 0.25}, burst=2.0,
                                         stall_ns=200.0)],
                     device=dev)


def _flash_lse_case(gen, b: int, window: int) -> dict:
    """The flash kernel with its lse against its plain version at gemma3's
    train heads (S=256, H=4, KVH=1, D=256) and batch ``b``: lse within
    LSE_TOL x max(1, |lse|), bf16 output as phase 2 holds it; its time
    against its bound, its plain version, ATen's flash attention (which
    also returns the lse) and the plain backward the train step runs."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.layers.attention import flash_attention_bwd

    dev = torch.device("cuda")
    s, h, kvh, d = TRAIN_SEQ, 4, 1, 256
    q = (3 * torch.randn(b, s, h, d, generator=gen, device=dev)
         ).to(torch.bfloat16)
    k = torch.randn(b, s, kvh, d, generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = (torch.rand(b, s, kvh, d, generator=gen, device=dev) * 3 - 1.5
         ).to(torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, window=window,
                                        return_lse=True)
    torch.cuda.synchronize()
    lse_err = (lse - plse).abs().max().item()
    lse_lim = LSE_TOL * max(1.0, plse.abs().max().item())
    o_err = (o.float() - po.float()).abs().max().item()
    rms = po.float().pow(2).mean().sqrt().item()
    if not (lse.shape == plse.shape == (b, kvh, h // kvh, s)
            and math.isfinite(lse_err) and lse_err <= lse_lim
            and o_err <= FLASH_BF16_TOL and rms >= 0.3):
        raise AssertionError(
            f"flash with lse at the train shapes, B={b}, window {window}: lse "
            f"error {lse_err} (limit {lse_lim}), output error {o_err} "
            f"(limit {FLASH_BF16_TOL}, reference rms {rms})")
    call = lambda: fa.flash_attention(q, k, v, window=window,  # noqa: E731
                                      return_lse=True)
    ms, dev_ms = _cuda_ms(call, n=20), _device_ms(call, n=20)
    plain = _cuda_ms(lambda: fa.flash_attention_plain(
        q, k, v, window=window, return_lse=True), n=5)
    # one library call with the same outputs: aten's flash attention
    # returns o and the lse; a window of 512 >= S is causal here
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt = kt.repeat_interleave(h // kvh, dim=1).contiguous()
    vt = vt.repeat_interleave(h // kvh, dim=1).contiguous()
    lib = None
    if window == 0 or window >= s:
        lib_op = torch.ops.aten._scaled_dot_product_flash_attention
        lib = _cuda_ms(lambda: lib_op(qt, kt, vt, 0.0, True), n=20)
    # the backward the train step runs after it: plain torch
    do = torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
    bwd_ms = _cuda_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, do, causal=True, window=window), n=5)
    flops = 4 * d * h * b * _pairs(s, s, window, s)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row = {"batch": b, "window": window, "lse_err": lse_err, "o_err": o_err,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
           "library_ms": lib, "plain_bwd_ms": bwd_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    _line(f"  flash+lse B={b} S={s} H={h} KVH={kvh} d={d} w={window}: "
          f"lse err {lse_err:.3g} (<= {lse_lim:.3g}), o err "
          f"{o_err:.3g}, {ms:.4f} ms, device "
          f"{'n/a' if dev_ms is None else f'{dev_ms:.4f} ms'}, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), "
          f"aten flash {'n/a' if lib is None else f'{lib:.4f} ms'}, "
          f"plain {plain:.3f} ms; plain backward {bwd_ms:.3f} ms")
    return row


def phase_train_kernels() -> dict:
    """Gate (a): the flash kernel with its lse against its plain version at
    the train shapes; and the QoS stall on the card: ``x`` itself back,
    no stream sync, and a chain that runs in full."""
    import torch
    from repro_torch.core import techniques as tech
    from repro_torch.kernels.dataplane import stall as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = [_flash_lse_case(gen, TRAIN_BATCH // TRAIN_RANKS, window)
            for window in (512, 0)]   # 5 of 6 gemma3 layers, then global
    lse_worst = max(r["lse_err"] for r in rows)
    o_worst = max(r["o_err"] for r in rows)

    # the stall: x itself back, no sync, the chain's slope
    x = torch.randn(1 << 20, generator=gen, device=dev)
    keep = x.clone()
    n_iters = 200_000
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    many = torch.full((), n_iters, dtype=torch.int32, device=dev)
    tech.delay_chain_dyn(x, zero)
    torch.cuda.synchronize()
    n0 = sk.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tech.delay_chain_dyn(x, it) for it in (zero, many)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not (all(o is x for o in outs) and torch.equal(_bits(x), _bits(keep))
            and sk.LAUNCHES - n0 == 2):
        raise AssertionError("the stall did not return x untouched with one "
                             "launch a call")
    ms0 = _cuda_ms(lambda: tech.delay_chain_dyn(x, zero), n=20)
    ms1 = _cuda_ms(lambda: tech.delay_chain_dyn(x, many), n=5)
    ns = (ms1 - ms0) * 1e6 / n_iters
    if ns < 1.0:
        raise AssertionError(f"stall chain slope {ns:.4f} ns/iteration < 1: "
                             f"the chain does not run in full")
    _line(f"  stall: x returned with no sync; {ms0 * 1e3:.2f} us at 0 "
          f"iterations, chain slope {ns:.3f} ns/iteration")
    _line(f"phase 5a train kernels ok: lse error {lse_worst:.3g} <= "
          f"{LSE_TOL} x max(1, |lse|), stall slope {ns:.3f} ns")
    return {"flash_lse": rows, "lse_worst_err": lse_worst,
            "o_worst_err": o_worst, "stall_ms_zero": ms0,
            "stall_ns_per_iter": ns}


def _cpu_throttled(n_ops: int) -> float:
    """The throttled count the port's CPU path gives for ``n_ops`` psums
    of the train tenant through the same dataplane."""
    import torch
    dp = _train_dataplane("cpu")
    st = dp.runtime_init()
    for _ in range(n_ops):
        _, st = dp.psum(torch.zeros(TRAIN_RANKS, 1), "data", state=st)
    return dp.runtime_report(st)["train"]["throttled"]


def phase_train() -> dict:
    """Train full-width, full-depth gemma3-1b for a few steps through the
    explicit-DP step and the converged dataplane; gates (b)-(e)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RunConfig, TrainConfig
    from repro_torch.core import telemetry as tl
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import DataConfig, SyntheticLM, to_torch
    from repro_torch.kernels.dataplane import bounce as bk
    from repro_torch.kernels.dataplane import kernel_cost_totals
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.train import init_state, make_explicit_dp_step
    from repro_torch.train import rank_grads, sync_grads
    from repro_torch.train import step as step_mod

    dev = torch.device("cuda")
    cfg = get_model_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(model, 0)
    torch.cuda.synchronize()
    leaves = tree_flatten(state.params)
    n_params = sum(p.numel() for _, p in leaves)
    _line(f"  {TRAIN_ARCH}: {cfg.num_layers} layers, {len(leaves)} leaves, "
          f"{n_params:,} f32 params and AdamW state in "
          f"{time.perf_counter() - t0:.1f} s; R={TRAIN_RANKS}, global batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}")
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH))
    batches = [to_torch(ds.batch_at(i), dev) for i in range(TRAIN_STEPS)]

    # (b) the kernel forward against the plain forward inside the same
    # autograd function, from the same state and batch, synced through a
    # dataplane of its own (the main path's counts stay clean)
    synced, losses = {}, {}
    for impl in ("flash", "plain"):
        ls, _, g = rank_grads(model, state.params, batches[0], TRAIN_RANKS,
                              impl=impl)
        mean, _, _ = sync_grads(_train_dataplane(dev), g, "data")
        del g
        synced[impl] = {path: m[0].clone() for path, m in tree_flatten(mean)}
        del mean
        losses[impl] = float(sum(x.item() for x in ls) / len(ls))
    rel = abs(losses["flash"] - losses["plain"]) / abs(losses["plain"])
    cos = {"/".join(p): torch.nn.functional.cosine_similarity(
        synced["flash"][p].flatten().double(),
        synced["plain"][p].flatten().double(), dim=0).item()
        for p in synced["flash"]}
    if not (math.isfinite(losses["flash"]) and rel <= TRAIN_LOSS_RTOL
            and min(cos.values()) > TRAIN_GRAD_COS):
        raise AssertionError(f"kernel vs plain forward: loss "
                             f"{losses['flash']} vs {losses['plain']} (rel "
                             f"{rel:.3g}), gradient cosines {cos}")
    _line(f"  (b) kernel vs plain forward: loss {losses['flash']:.5f} vs "
          f"{losses['plain']:.5f} (rel {rel:.2e} <= {TRAIN_LOSS_RTOL}), "
          f"min gradient cosine {min(cos.values()):.6f} over {len(cos)} "
          f"leaves")
    del synced
    gc.collect()
    torch.cuda.empty_cache()
    peak_b_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    # the main path: TRAIN_STEPS steps with runtime accounting; sync_grads
    # timed and run under the sync debug mode (gate d)
    dp = _train_dataplane(dev)
    run = RunConfig(train=TrainConfig(steps=TRAIN_STEPS, learning_rate=5e-3,
                                      warmup_steps=2))
    step = make_explicit_dp_step(model, run, dp, runtime_accounting=True)
    sync_ms = []
    real_sync = step_mod.sync_grads

    def timed_sync(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_sync(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t) * 1e3)
        return out

    step_mod.sync_grads = timed_sync
    rt = dp.runtime_init()
    wall, per_step, metrics = [], [], []
    try:
        _reset_launches()
        fa.LSE_LAUNCHES = 0
        for i in range(TRAIN_STEPS):
            n0 = {**_launches(), "flash_lse": fa.LSE_LAUNCHES}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m, rt = step(state, batches[i], rt)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
            per_step.append({k: v - n0[k] for k, v in
                             {**_launches(),
                              "flash_lse": fa.LSE_LAUNCHES}.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {**_launches(), "flash_lse": fa.LSE_LAUNCHES}
    finally:
        step_mod.sync_grads = real_sync
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_losses = [mt["loss"] for mt in metrics]
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError(f"a loss is not finite: {step_losses}")

    # (c) the runtime report against what the path must give
    rep = dp.runtime_report(rt)["train"]
    sizes = [p.numel() for _, p in leaves]
    n_ops = len(sizes) * TRAIN_STEPS
    rec_bytes = dp.telemetry.by_kind()["all_reduce"]["bytes"]
    acc_bytes, acc_iters = np.float32(0), np.float32(0)
    rec0 = tl.OpRecord("all_reduce", "", 0, ())
    send = (dp.pipeline.send_delay_iters(rec0), dp.pipeline.send_copies(rec0))
    done = (dp.pipeline.complete_delay_iters(rec0),
            dp.pipeline.complete_copies(rec0))
    sides = sum(1 for it, cp in (send, done) if it or cp)
    for _ in range(TRAIN_STEPS):       # issue order: leaves reversed
        for n in reversed(sizes):
            acc_bytes = np.float32(acc_bytes + np.float32(4 * n))
            for it, cp in (send, done):
                acc_iters = np.float32(acc_iters + np.float32(
                    kernel_cost_totals(n, it, cp)[0]))
    throttled = _cpu_throttled(n_ops)
    want = {"ops": float(n_ops), "bytes": float(acc_bytes),
            "throttled": throttled, "kernel_iters": float(acc_iters)}
    got = {k: rep[k] for k in want}
    if got != want or rec_bytes != TRAIN_STEPS * 4 * n_params:
        raise AssertionError(f"runtime report {got}, want {want}; recorded "
                             f"bytes {rec_bytes}, want "
                             f"{TRAIN_STEPS * 4 * n_params}")
    # (e) launches per step
    per = {"flash_attention": cfg.num_layers * TRAIN_RANKS,
           "flash_lse": cfg.num_layers * TRAIN_RANKS,
           "bounce": TRAIN_RANKS * len(sizes) * sides,
           "bounce_stall": TRAIN_RANKS * len(sizes), "ssm_scan": 0}
    if any(p != per for p in per_step):
        raise AssertionError(f"launches per step {per_step}, want {per}")

    # one more step under torch.profiler: device busy time, the largest
    # kernels, and the host's launches
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _, rt = step(state, batches[0], rt)
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    busy_ms = _kernel_us(events) / 1e3
    top = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                  for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[2])[:8]
    n_launch = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    # the port's kernels in that step: device ms and launches
    step_kernels = {name: (sum(e.self_device_time_total for e in events
                               if e.device_type == DeviceType.CUDA
                               and sym in e.key) / 1e3,
                           sum(e.count for e in events
                               if e.device_type == DeviceType.CUDA
                               and sym in e.key))
                    for name, sym in (("bounce", "bounce_kernel"),
                                      ("flash_lse", "flash_fwd_sm90"),
                                      ("bounce_stall", "stall_kernel"))}

    # the psums' bounce launches on payloads of the gradients' shapes (the
    # parameters as rank 0's, the first moments as rank 1's): bit
    # identity, time against torch.clone of the same payloads
    grads = [(p, m) for (_, p), (_, m) in
             zip(tree_flatten(state.params), tree_flatten(state.opt.mu))]
    iters = send[0]
    for g in grads:
        for r in range(TRAIN_RANKS):
            out, ctr = bk.mediated_cost(g[r], iters, 0)
            want_out, want_ctr = bk.mediated_cost_plain(g[r], iters, 0)
            if not (torch.equal(_bits(out), _bits(want_out))
                    and torch.equal(ctr, want_ctr)):
                raise AssertionError("a psum's bounce differs from its plain "
                                     "version")
            del out, want_out

    def bounces():
        for g in grads:
            for r in range(TRAIN_RANKS):
                bk.mediated_cost(g[r], iters, 0)

    def clones():
        for g in grads:
            for r in range(TRAIN_RANKS):
                g[r].clone()

    def plains():
        for g in grads:
            for r in range(TRAIN_RANKS):
                bk.mediated_cost_plain(g[r], iters, 0)

    # the stall at one missing token's trip count, and its plain version
    from repro_torch.kernels.dataplane import stall as sk
    trip = dp.policies[1]._stall_iters
    one = torch.zeros(1, device=dev)
    trip_t = torch.full((), trip, dtype=torch.int32, device=dev)
    stall_ms = _cuda_ms(lambda: sk.stall(one, trip_t), n=20)
    stall_plain_ms = _wall_ms(lambda: sk.stall_plain(one, trip_t), n=5)
    bounce_ms = _cuda_ms(bounces, n=3, warmup=1)
    bounce_dev = step_kernels["bounce"][0]   # the profiled step's psums
    clone_ms = _cuda_ms(clones, n=3, warmup=1)
    plain_ms = _cuda_ms(plains, n=2, warmup=1)
    moved = 2 * TRAIN_RANKS * 4 * n_params
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    del grads
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = {"arch": TRAIN_ARCH, "ranks": TRAIN_RANKS,
           "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "n_params": n_params, "leaves": len(sizes),
           "losses": step_losses, "metrics": metrics,
           "loss_kernel_vs_plain": losses, "grad_cos_min": min(cos.values()),
           "step_wall_ms": wall, "sync_grads_ms": sync_ms,
           "psum_bounce_ms": bounce_ms, "psum_bounce_device_ms": bounce_dev,
           "psum_clone_ms": clone_ms, "psum_bounce_plain_ms": plain_ms,
           "psum_bounce_bound_ms": bound_ms, "psum_bounce_err": 0.0,
           "peak_gb": peak_gb, "peak_gate_b_gb": peak_b_gb,
           "profiled_step_wall_ms": prof_wall, "device_busy_ms": busy_ms,
           "cuda_launches_per_step": n_launch, "top_device": top,
           "step_kernel_device_ms": step_kernels,
           "report": got, "recorded_bytes": rec_bytes,
           "launches": launches, "launches_per_step": per_step[0],
           "stall_iters": trip, "stall_ms": stall_ms,
           "stall_plain_ms": stall_plain_ms, "card": smi}
    fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs)  # noqa: E731
    _line(f"  losses {', '.join(f'{x:.5f}' for x in step_losses)}; step wall "
          f"ms (synchronised) {fmt(wall)}; sync_grads ms {fmt(sync_ms)} "
          f"(no stream sync under the sync debug mode)")
    _line(f"  psums' bounce launches ({TRAIN_RANKS} x {len(sizes)}, "
          f"{moved / 1e9:.2f} GB moved): {bounce_ms:.3f} ms events, "
          f"{bounce_dev:.3f} ms device in the profiled step; "
          f"torch.clone of the same {clone_ms:.3f} ms; bound "
          f"{bound_ms:.3f} ms; plain {plain_ms:.3f} ms")
    _line(f"  report {got}; recorded bytes {rec_bytes:,}; launches per step "
          f"{per_step[0]}; peak memory {peak_gb:.2f} GB ({peak_b_gb:.2f} "
          f"GB in gate b); card {smi}")
    _line(f"  profiled step: {prof_wall:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms, {n_launch} cudaLaunchKernel calls; port "
          f"kernels (device ms, launches) {step_kernels}")
    for key, count, ms in top:
        _line(f"    device {ms:8.3f} ms {count:5d}x {key[:70]}")
    _line(f"phase 5 train {TRAIN_ARCH} ok: {TRAIN_STEPS} steps, gates (b)-(e) "
          f"held")
    return res


# ---------------------------------------------------------------------------
# phase 6: the GSPMD step, the launcher and its checkpoints, chunked_psum
# ---------------------------------------------------------------------------

GSPMD_MODES = ("none", "full", "dots")
REMAT_LOSS_RTOL = 1e-5
REMAT_GRAD_COS = 0.9999
RESUME_LOSS_RTOL = 1e-6
PSUM_CHUNKS = 4
CE_CHUNK = 512            # models/losses.chunked_ce_loss's default chunk


def _gspmd_launches(cfg) -> dict:
    """Launches one GSPMD step must make, read from the model's code:
    ``{mode: {"forward": {...}, "backward": {...}}}``.  Forward: embed
    table and output, 7 edges a layer (attn q, k, v, out; mlp hidden, out;
    layer out), the loss's table and one ``loss/logits`` a cross-entropy
    chunk, each one bounce launch (cord's cost is on the send side only);
    flash with lse once a layer.  Backward: the recomputed cross-entropy
    chunks' ``loss/logits`` edges, and under remat every layer's edges and
    flash forward again; nothing else (a transpose launches nothing)."""
    layer = 7 * cfg.num_layers
    ce = -(-TRAIN_SEQ // min(CE_CHUNK, TRAIN_SEQ))
    out = {}
    for mode in GSPMD_MODES:
        again = mode != "none"
        fwd = {"bounce": 2 + layer + 1 + ce,
               "flash_attention": cfg.num_layers,
               "flash_lse": cfg.num_layers, "bounce_stall": 0, "ssm_scan": 0}
        bwd = {"bounce": ce + (layer if again else 0),
               "flash_attention": cfg.num_layers if again else 0,
               "flash_lse": cfg.num_layers if again else 0,
               "bounce_stall": 0, "ssm_scan": 0}
        out[mode] = {"forward": fwd, "backward": bwd}
    return out


def _cos(a, b) -> float:
    import torch
    return torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item()


def phase_train_gspmd() -> dict:
    """6a: ``make_train_step`` on full-width gemma3-1b through phase 5's
    dataplane on ``make_local_mesh()`` with ``activation_rules`` for the
    train shape: gates (a)-(f)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import DataConfig, SyntheticLM, to_torch
    from repro_torch.kernels.dataplane import bounce as bk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import activation_rules
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train import step as step_mod

    dev = torch.device("cuda")
    cfg = get_model_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    state = init_state(model, 0)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH))
    batches = [to_torch(ds.batch_at(i), dev) for i in range(TRAIN_STEPS)]
    mesh = make_local_mesh()
    rules = activation_rules(cfg, ShapeConfig("train", TRAIN_SEQ,
                                              TRAIN_BATCH, "train"))
    want = _gspmd_launches(cfg)

    def counts():
        return {**_launches(), "flash_lse": fa.LSE_LAUNCHES}

    # (a) loss and gradients with the dataplane against dp=None, bit for
    # bit; (b) every gradient leaf there and nonzero
    def grads(dp):
        (loss, _), g = step_mod._value_and_grad(
            lambda p, b: model.loss(p, b, dp=dp), state.params, batches[0])
        return loss, dict(tree_flatten(g))

    l_bare, g_bare = grads(None)
    l_dp, g_dp = grads(_train_dataplane(dev, mesh, rules))
    differ = [p for p in g_bare if not torch.equal(_bits(g_bare[p]),
                                                   _bits(g_dp[p]))]
    if differ or not torch.equal(_bits(l_bare), _bits(l_dp)):
        l_again, g_again = grads(None)
        repeat = [p for p in g_bare if not torch.equal(
            _bits(g_bare[p]), _bits(g_again[p]))]
        raise AssertionError(
            f"(a) with the dataplane: loss {l_dp.item()!r} against "
            f"{l_bare.item()!r}, gradients differ in {differ}; dp=None run "
            f"again: loss {l_again.item()!r}, differs in {repeat}")
    bad = [p for p, g in g_dp.items()
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    n_leaves = len(tree_flatten(state.params))
    if bad or len(g_dp) != n_leaves:
        raise AssertionError(f"(b) gradient leaves zero, not finite or "
                             f"missing: {bad}; {len(g_dp)} of {n_leaves}")
    _line(f"  (a) loss {l_dp.item():.6f} and {len(g_dp)} gradients with the "
          f"dataplane bit for bit those without; (b) none zero")
    del g_bare, g_dp
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: TRAIN_STEPS steps with remat "none", then one step
    # each with "full" and "dots" from the state before the last one
    dp = _train_dataplane(dev, mesh, rules)
    marks = []

    def loss_counted(params, batch, **kw):
        out = model.loss(params, batch, **kw)
        marks.append(counts())          # the forward's end
        return out

    counted = dataclasses.replace(model, loss=loss_counted)
    captured = {}
    real_vg = step_mod._value_and_grad

    def capturing(loss_fn, params, batch):
        out = real_vg(loss_fn, params, batch)
        captured["loss"], captured["grads"] = out[0][0], dict(
            tree_flatten(out[1]))
        return out

    steps = {}
    for mode in GSPMD_MODES:
        run = RunConfig(train=TrainConfig(steps=TRAIN_STEPS,
                                          learning_rate=5e-3, warmup_steps=2,
                                          remat=mode))
        step, shard = make_train_step(counted, run, dp)
        steps[mode] = shard(state, batches[0])
    st_spec, b_spec = steps["none"].in_specs

    rows = []

    def one(mode, s, batch):
        dp.telemetry.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0 = counts()
        marks.clear()
        t = time.perf_counter()
        s, m = steps[mode](s, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        n1 = counts()
        fwd = {k: marks[0][k] - n0[k] for k in n0}
        bwd = {k: n1[k] - marks[0][k] for k in n0}
        rows.append({"remat": mode, "wall_ms": wall, "loss": float(m["loss"]),
                     "forward": fwd, "backward": bwd,
                     "records": [(r.kind, r.tag)
                                 for r in dp.telemetry.records],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "peak_over_held_gb": (torch.cuda.max_memory_allocated()
                                           - base) / 1e9})
        return s

    step_mod._value_and_grad = capturing
    try:
        _reset_launches()
        fa.LSE_LAUNCHES = 0
        s = state
        for i in range(TRAIN_STEPS):
            if i == TRAIN_STEPS - 1:
                before_last = s
            s = one("none", s, batches[i])
        ref = (captured["loss"], captured["grads"])
        remat_cmp = {}
        for mode in ("full", "dots"):
            one(mode, before_last, batches[-1])
            rel = abs(captured["loss"].item() - ref[0].item()) / abs(
                ref[0].item())
            cos = min(_cos(captured["grads"][p], ref[1][p]) for p in ref[1])
            remat_cmp[mode] = {"loss_rel": rel, "grad_cos_min": cos}
            captured.clear()
        launches = counts()
    finally:
        step_mod._value_and_grad = real_vg
    del ref, before_last
    gc.collect()
    torch.cuda.empty_cache()

    # (c) remat against none; (d) records; (e) launches
    for mode, c in remat_cmp.items():
        if not (c["loss_rel"] <= REMAT_LOSS_RTOL
                and c["grad_cos_min"] > REMAT_GRAD_COS):
            raise AssertionError(f"(c) remat {mode!r} against 'none': {c}")
    recs = {r["remat"]: r["records"] for r in rows}
    if any(r["records"] != rows[0]["records"] for r in rows) or \
            len(rows[0]["records"]) != want["none"]["forward"]["bounce"]:
        lens = {k: len(v) for k, v in recs.items()}
        raise AssertionError(f"(d) records per step differ across remat "
                             f"modes: {lens}")
    got = [(r["remat"], r["forward"], r["backward"]) for r in rows]
    need = [(m, want[m]["forward"], want[m]["backward"])
            for m in ["none"] * TRAIN_STEPS + ["full", "dots"]]
    if got != need:
        raise AssertionError(f"(e) launches per step {got}, want {need}")
    losses = [r["loss"] for r in rows[:TRAIN_STEPS]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")

    # (f) one profiled step: the device's busy time in it
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s, _ = steps["none"](s, batches[0])
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    busy_ms = _kernel_us(events) / 1e3
    bounce_dev = sum(e.self_device_time_total for e in events
                     if "bounce_kernel" in e.key) / 1e3
    n_launch = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    del s, state, batches
    gc.collect()
    torch.cuda.empty_cache()

    # the kernels at this path's shapes: the loss/logits edge's bounce
    # (4 x 256 x 262144 f32, 1.07 GB) and flash with lse at B = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), generator=gen,
                    device=dev)
    from repro_torch.core import telemetry as tl
    iters = dp.pipeline.send_delay_iters(tl.OpRecord("constraint", "", 0, ()))
    out, ctr = bk.mediated_cost(x, iters, 0)
    p_out, p_ctr = bk.mediated_cost_plain(x, iters, 0)
    if not (torch.equal(_bits(out), _bits(x)) and torch.equal(
            _bits(out), _bits(p_out)) and torch.equal(ctr, p_ctr)):
        raise AssertionError("the logits edge's bounce differs from its "
                             "plain version")
    del out, p_out
    logits_edge = {
        "bytes": x.nbytes, "iters": iters, "max_abs_err": 0.0,
        "ms": _cuda_ms(lambda: bk.mediated_cost(x, iters, 0), n=5),
        "plain_ms": _cuda_ms(lambda: bk.mediated_cost_plain(x, iters, 0),
                             n=2, warmup=1),
        "library_ms": _cuda_ms(lambda: x.clone(), n=5),
        "bound_ms": 2 * x.nbytes / HBM_BYTES_PER_S * 1e3,
        "device_ms_in_profiled_step": bounce_dev}
    del x
    flash_b4 = _flash_lse_case(gen, TRAIN_BATCH, 512)
    torch.cuda.empty_cache()

    for r in rows:
        _line(f"  remat {r['remat']:4s}: loss {r['loss']:.5f}, step wall "
              f"{r['wall_ms']:.1f} ms, launches forward {r['forward']} "
              f"backward {r['backward']}, peak {r['peak_gb']:.2f} GB "
              f"({r['peak_over_held_gb']:.2f} over what was held)")
    _line(f"  (c) {remat_cmp}; (d) {len(rows[0]['records'])} records a step "
          f"in every mode; specs: embed/tok {st_spec.params['embed']['tok']}, "
          f"tokens {b_spec['tokens']}")
    _line(f"  profiled step: {prof_wall:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms, bounce {bounce_dev:.2f} ms, {n_launch} "
          f"cudaLaunchKernel calls")
    _line(f"  loss/logits edge {logits_edge['bytes'] / 1e9:.2f} GB: bounce "
          f"{logits_edge['ms']:.4f} ms, clone {logits_edge['library_ms']:.4f} "
          f"ms, bound {logits_edge['bound_ms']:.4f} ms, plain "
          f"{logits_edge['plain_ms']:.3f} ms")
    _line(f"phase 6a GSPMD step {TRAIN_ARCH} ok: gates (a)-(f) held")
    return {"steps": [{k: v for k, v in r.items() if k != "records"}
                      for r in rows],
            "records_per_step": len(rows[0]["records"]),
            "want_launches": want, "remat": remat_cmp,
            "loss_with_dp": l_dp.item(), "launches": launches,
            "profiled_step_wall_ms": prof_wall, "device_busy_ms": busy_ms,
            "cuda_launches_per_step": n_launch, "logits_edge": logits_edge,
            "flash_lse_b4": flash_b4}


def phase_launcher() -> dict:
    """6b: ``repro_torch.launch.train.main`` at full width, 3 steps with a
    checkpoint at step 2, then again: the second run resumes from step 2
    and its one step's loss is the first run's third."""
    import os
    import shutil
    import tempfile
    import threading

    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch import train as launch_train

    tmp = tempfile.mkdtemp(prefix="cord_ckpt_")
    need = 13e9          # params, mu, nu of 999,826,048 f32 each, and more
    free = shutil.disk_usage(tmp).free
    _line(f"  checkpoint directory {tmp}: {free / 1e9:.1f} GB free")
    if free < need:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"{free} bytes free under {tmp}, a checkpoint "
                             f"needs {need:.0f}")
    times = {}
    real_save, real_restore = store.save, store.restore

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        th = real_save(ckpt_dir, step, tree, **kw)
        times["save_call_ms"] = (time.perf_counter() - t0) * 1e3

        def watch():            # the write ends when the writer does
            if th is not None:
                th.join()
            times["write_ms"] = (time.perf_counter() - t0) * 1e3
        w = threading.Thread(target=watch)
        w.start()
        times["watch"] = w
        return th

    def timed_restore(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_restore(*args, **kw)
        torch.cuda.synchronize()
        times["restore_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    argv = ["--full", f"steps={TRAIN_STEPS}", f"seq_len={TRAIN_SEQ}",
            f"global_batch={TRAIN_BATCH}", "checkpoint_every=2",
            f"checkpoint_dir={tmp}", "log_every=1"]
    store.save, store.restore = timed_save, timed_restore
    try:
        t = time.perf_counter()
        s1, rep1 = launch_train.main(argv)
        first_s = time.perf_counter() - t
        times.pop("watch").join()
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp, "step_00000002")
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
        t = time.perf_counter()
        s2, rep2 = launch_train.main(argv)
        second_s = time.perf_counter() - t
        # the resumed run ends in the first run's state, bit for bit: the
        # restored parameters and moments were the checkpointed ones
        trees = [{"params": s.params, "mu": s.opt.mu, "nu": s.opt.nu,
                  "step": s.step} for s in (s1, s2)]
        differ = [p for (p, a), (_, b) in zip(tree_flatten(trees[0]),
                                              tree_flatten(trees[1]))
                  if not torch.equal(_bits(a), _bits(b))]
        del s1, s2, trees
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        store.save, store.restore = real_save, real_restore
        shutil.rmtree(tmp, ignore_errors=True)
    l1 = [m["loss"] for m in rep1.metrics]
    l2 = [m["loss"] for m in rep2.metrics]
    rel = abs(l2[0] - l1[-1]) / abs(l1[-1]) if l2 else math.inf
    if not (rep1.steps_run == TRAIN_STEPS and rep1.restores == 0
            and rep2.restores == 1 and rep2.steps_run == 1
            and rel <= RESUME_LOSS_RTOL and not differ):
        raise AssertionError(
            f"launcher resume: first run {rep1.steps_run} steps, losses "
            f"{l1}; second run {rep2.restores} restores, {rep2.steps_run} "
            f"steps, losses {l2} (rel {rel}); final states differ in "
            f"{differ}")
    _line(f"  launcher: losses {l1}, resumed {l2} (rel {rel:.2e} <= "
          f"{RESUME_LOSS_RTOL}), the same final state bit for bit; "
          f"checkpoint {nbytes:,} bytes, write "
          f"{times['write_ms']:.0f} ms ({times['save_call_ms']:.0f} ms "
          f"blocking the loop), restore {times['restore_ms']:.0f} ms; runs "
          f"{first_s:.1f} s and {second_s:.1f} s")
    _line("phase 6b launcher ok: resumed from step 2")
    return {"losses": l1, "resumed_losses": l2, "resume_rel": rel,
            "checkpoint_bytes": nbytes, "write_ms": times["write_ms"],
            "save_blocking_ms": times["save_call_ms"],
            "restore_ms": times["restore_ms"],
            "step_ms_first": [t * 1e3 for t in rep1.step_times],
            "run_s": [first_s, second_s]}


def phase_chunked_psum() -> dict:
    """6c: ``chunked_psum`` of a rank-stacked R = 2 payload of the
    ``embed/tok`` leaf's size in 4 chunks under phase 5's QoS bucket: bit
    for bit ``dp.psum``'s, ``chunks`` and ``throttled`` as on the CPU, and
    no stream sync."""
    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.core.chunking import chunked_psum

    dev = torch.device("cuda")
    cfg = get_model_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((TRAIN_RANKS, cfg.vocab_size, cfg.d_model),
                    generator=gen, device=dev)
    reports, res = {}, {}
    for where in ("cuda", "cpu"):
        d = torch.device(where)
        dp = _train_dataplane(d)
        xd = x if where == "cuda" else x.cpu()
        whole, _ = dp.psum(xd, "data")
        rt = dp.runtime_init()
        if where == "cuda":
            torch.cuda.synchronize()
            n0 = _launches()
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, rt = chunked_psum(dp, xd, "data", num_chunks=PSUM_CHUNKS,
                                   state=rt)
        finally:
            if where == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        if where == "cuda":
            torch.cuda.synchronize()
            res["ms"] = (time.perf_counter() - t) * 1e3
            res["launches"] = _delta(n0)
        if not torch.equal(_bits(out), _bits(whole)):
            raise AssertionError(f"chunked_psum on {where} differs from psum")
        rep = dp.runtime_report(rt)["train"]
        reports[where] = {k: rep[k] for k in ("ops", "bytes", "chunks",
                                              "throttled")}
        del whole, out, xd
    if reports["cuda"] != reports["cpu"] or \
            reports["cuda"]["chunks"] != PSUM_CHUNKS:
        raise AssertionError(f"chunked_psum reports: card {reports['cuda']}, "
                             f"CPU {reports['cpu']}")
    want = {"bounce": TRAIN_RANKS * PSUM_CHUNKS, "bounce_stall": PSUM_CHUNKS}
    if any(res["launches"][k] != v for k, v in want.items()):
        raise AssertionError(f"chunked_psum launches {res['launches']}, want "
                             f"{want}")
    _line(f"  chunked_psum of {x.nbytes / 1e9:.2f} GB (R={TRAIN_RANKS}, "
          f"{PSUM_CHUNKS} chunks): bit for bit psum, report {reports['cuda']} "
          f"as on the CPU, no stream sync, {res['ms']:.2f} ms, launches "
          f"{res['launches']}")
    _line("phase 6c chunked_psum ok")
    return {"bytes": x.nbytes, "report": reports["cuda"], **res}


# ---------------------------------------------------------------------------
# phase 7: the verbs transport and perftest
# ---------------------------------------------------------------------------

VERBS_RANKS = 2          # mesh ("rank",) of 2 ranks on the one card
VERBS_N = 64             # messages a windowed transfer
VERBS_WINDOW = 16
VERBS_CASES = (("RC", "send", 65_536), ("RC", "write", 65_536),
               ("RC", "read", 65_536), ("RC", "send", 1_048_576),
               ("RC", "write", 1_048_576), ("RC", "read", 1_048_576),
               ("UD", "send", 4096))
LOSSY = dict(drop_rate=0.1, corrupt_rate=0.05, seed=9)
# repro's WireFault(**LOSSY) over wr < 64, attempt < 4: the flat indices
# wr * 4 + attempt that it drops and corrupts (tests/test_torch_wirefault.py
# holds these to repro's own)
GOLDEN_GRID = (64, 4)
GOLDEN_DROPS = (3, 4, 6, 29, 45, 48, 50, 75, 112, 130, 145, 147, 156, 158,
                159, 160, 162, 167, 174, 177, 190, 225, 227, 231, 252)
GOLDEN_CORRUPTS = (17, 19, 33, 64, 81, 131, 160, 229)
FIG3_REPS = 5
REPORT_KEYS = ("ops", "bytes", "credits", "completions", "stalls",
               "cq_depth")


def _verbs_dp(device, pallas: str = "auto"):
    from repro_torch.configs.base import DataplaneConfig
    from repro_torch.core.dataplane import Dataplane
    from repro_torch.launch.mesh import make_mesh
    return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True,
                                     pallas_dataplane=pallas),
                     mesh=make_mesh((VERBS_RANKS,), ("rank",)),
                     device=device)


def _verbs_payload(gen, n: int, msg_bytes: int):
    """(R, n, msg_bytes) uint8 on the card: random bytes on every rank
    (rank 1's are READ's remote memory)."""
    import torch
    return torch.randint(0, 256, (VERBS_RANKS, n, msg_bytes), generator=gen,
                         device="cuda", dtype=torch.uint8)


def _windowed(device, transport, op, msg_bytes, msgs, *, pallas="auto",
              fault=None, credits=VERBS_N, no_sync=False):
    """One windowed transfer src 0 → dst 1 (credits granted first for a
    send); returns (out, QP snapshot, report, launches, seconds)."""
    import torch
    from repro_torch.core import verbs
    dp = _verbs_dp(device, pallas)
    cfg = verbs.QPConfig(transport=transport, msg_bytes=msg_bytes,
                         depth=VERBS_WINDOW, max_outstanding=VERBS_WINDOW)
    m = msgs.to(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    qp = verbs.qp_init(cfg, device=device)
    rt = dp.runtime_init()
    if op == "send":
        qp, rt = verbs.post_recv(dp, cfg, qp, dst=1, n=credits, state=rt)
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out, qp, rt = verbs.windowed_send(dp, cfg, qp, m, 0, 1, op=op,
                                          state=rt, fault=fault)
    finally:
        if no_sync:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches()
    rep = dp.runtime_report(verbs.allreduce_state(rt))["default"]
    return out, verbs.qp_snapshot(qp), rep, launches, secs


def _same_snap(a: dict, b: dict) -> bool:
    import numpy as np
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _count_chains(fn):
    """``fn()`` on the CPU, counting the delay chains it runs with work:
    each is one bounce launch on the card (cord's fused send side and a
    stall or backoff tick both run exactly one chain)."""
    from repro_torch.core import techniques as tech
    orig, n = tech.delay_chain, [0]

    def counting(x, iters):
        n[0] += iters > 0
        return orig(x, iters)

    tech.delay_chain = counting
    try:
        out = fn()
    finally:
        tech.delay_chain = orig
    return out, n[0]


def phase_verbs() -> dict:
    """7a and 7b: windowed transfers through a cord dataplane with cost
    emulation on a ("rank",) mesh of 2 ranks on the card, held against
    the same transfers on the CPU (the CPU's delay slope pinned to the
    card's, so the kernel's counters compare too)."""
    import numpy as np
    import torch
    from repro_torch.bench import perftest
    from repro_torch.core import techniques as tech
    from repro_torch.core import verbs
    from repro_torch.runtime.fault import WireFault

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    probe = ("cpu", 200_000)          # techniques.calibrate()'s key
    had = tech._CALIBRATION.get(probe)
    tech._CALIBRATION[probe] = tech.calibrate(device=dev)
    res = {"cases": [], "launches": 0}
    try:
        # -- 7a: bit identity, reports, pallas off, exact launches --------
        for transport, op, size in VERBS_CASES:
            msgs = _verbs_payload(gen, VERBS_N, size)
            src, dst = (1, 0) if op == "read" else (0, 1)
            got, snap, rep, launches, secs = _windowed(
                "cuda", transport, op, size, msgs, no_sync=True)
            res["launches"] += launches["bounce"]
            want_launches = VERBS_N + (op == "send")
            if not torch.equal(got[dst], msgs[src]) or got[src].any():
                raise AssertionError(f"verbs {transport} {op} {size}: "
                                     f"delivery differs from the input")
            if launches["bounce"] != want_launches or \
                    sum(launches.values()) != want_launches:
                raise AssertionError(f"verbs {transport} {op} {size}: "
                                     f"launches {launches}, want bounce "
                                     f"{want_launches} and nothing else")
            off = _windowed("cuda", transport, op, size, msgs, pallas="off")
            cpu = _windowed("cpu", transport, op, size, msgs.cpu())
            for name, o in (("pallas off", off), ("cpu", cpu)):
                if not (torch.equal(o[0].cpu(), got.cpu())
                        and _same_snap(o[1], snap) and o[2] == rep):
                    raise AssertionError(
                        f"verbs {transport} {op} {size}: the card's run and "
                        f"{name} differ: {rep} against {o[2]}")
            if off[3]["bounce"] != want_launches:
                raise AssertionError(f"pallas off launches {off[3]}")
            if rep["ops"] != want_launches or rep["completions"] != VERBS_N \
                    or rep["credits"] != (VERBS_N if op == "send" else 0):
                raise AssertionError(f"verbs report {rep}")
            ticks = VERBS_N + rep["completions"] + rep["stalls"]
            row = {"transport": transport, "op": op, "bytes": size,
                   "launches": launches["bounce"], "ticks": int(ticks),
                   "wall_ms": secs * 1e3,
                   "host_us_per_tick": secs * 1e6 / ticks,
                   "report": {k: rep[k] for k in REPORT_KEYS},
                   "kernel_iters": rep["kernel_iters"],
                   "win_hwm": int(snap["win_hwm"]),
                   "cq_hwm": int(snap["cq_hwm"])}
            res["cases"].append(row)
            _line(f"  verbs {transport} {op} {size} B x {VERBS_N}: bit for bit,"
                  f" as the CPU's and with pallas off; {launches['bounce']} "
                  f"bounce launches, no sync; {secs * 1e3:.2f} ms, "
                  f"{row['host_us_per_tick']:.1f} us a tick over {ticks:.0f} "
                  f"ticks; report {row['report']}")
            del msgs, got, off, cpu

        # the synchronous path: each rank's pipeline on its own state
        n_sync = 16
        msgs = _verbs_payload(gen, n_sync, 65_536)
        reps = {}
        for where in ("cuda", "cpu"):
            dp = _verbs_dp(where)
            cfg = verbs.QPConfig(msg_bytes=65_536, depth=n_sync)
            qp, rt = verbs.qp_init(cfg, device=where), dp.runtime_init()
            m = msgs.to(where)
            for i in range(n_sync):
                qp, rt = verbs.post_send(dp, cfg, qp, m[:, i], src=0,
                                         state=rt)
            qp, rt = verbs.flush_send(dp, cfg, qp, src=0, dst=1, state=rt)
            done, qp, rt = verbs.poll_cq(dp, cfg, qp, poller=1, state=rt)
            reps[where] = dp.runtime_report(verbs.allreduce_state(rt))[
                "default"]
            if done != n_sync or not torch.equal(qp["recv_ring"][1].cpu(),
                                                 msgs[0].cpu()):
                raise AssertionError(f"sync path on {where}: {done} done")
        want = {"ops": n_sync + VERBS_RANKS, "completions": n_sync}
        if reps["cuda"] != reps["cpu"] or \
                any(reps["cuda"][k] != v for k, v in want.items()):
            raise AssertionError(f"sync path report {reps}, want {want}")
        _line(f"  verbs sync path: {n_sync} posts + flush + poll, report "
              f"ops {reps['cuda']['ops']:.0f} (each rank's own state), as "
              f"on the CPU")
        res["post_host_us"] = _post_host_us()
        _line("phase 7a verbs ok")

        # -- 7b: loss, migration, churn -----------------------------------
        fault = WireFault(**LOSSY)
        n, a = GOLDEN_GRID
        w = torch.arange(n).repeat_interleave(a)
        t = torch.arange(a).repeat(n)
        for name, golden in (("drops_wr", GOLDEN_DROPS),
                             ("corrupts_wr", GOLDEN_CORRUPTS)):
            hit = getattr(fault, name)(w, t)
            ints = [k for k in range(n * a)
                    if getattr(fault, name)(k // a, k % a)]
            if tuple(torch.nonzero(hit).flatten().tolist()) != golden or \
                    tuple(ints) != golden:
                raise AssertionError(f"WireFault.{name} differs from "
                                     f"repro's schedule")
        msgs = _verbs_payload(gen, VERBS_N, 65_536)
        clean = _windowed("cuda", "RC", "send", 65_536, msgs)
        lossy = _windowed("cuda", "RC", "send", 65_536, msgs, fault=fault,
                          no_sync=True)
        res["launches"] += lossy[3]["bounce"]
        cpu, chains = _count_chains(lambda: _windowed(
            "cpu", "RC", "send", 65_536, msgs.cpu(), fault=fault))
        lrep = lossy[2]
        if not torch.equal(lossy[0], clean[0]) or lrep["retransmits"] <= 0:
            raise AssertionError(f"lossy transfer: bit-identical "
                                 f"{torch.equal(lossy[0], clean[0])}, "
                                 f"report {lrep}")
        if not (_same_snap(cpu[1], lossy[1]) and cpu[2] == lrep):
            raise AssertionError(f"lossy transfer: card {lrep}, CPU {cpu[2]}")
        if lossy[3]["bounce"] != chains:
            raise AssertionError(f"lossy launches {lossy[3]['bounce']}, the "
                                 f"code gives {chains}")
        res["lossy"] = {"report": {k: lrep[k] for k in REPORT_KEYS
                                   + ("retransmits", "timeouts",
                                      "cqe_errors")},
                        "launches": lossy[3]["bounce"],
                        "wall_ms": lossy[4] * 1e3,
                        "lossless_wall_ms": clean[4] * 1e3}
        _line(f"  verbs lossy RC send 64 KiB x {VERBS_N} under {LOSSY}: bit "
              f"for bit the lossless run, report as the CPU's "
              f"({res['lossy']['report']}), {chains} bounce launches as the "
              f"code gives; {lossy[4] * 1e3:.2f} ms against lossless "
              f"{clean[4] * 1e3:.2f} ms")

        # a windowed transfer quiesced halfway, snapshotted, restored into
        # a fresh QP and finished
        mesh = perftest.make_mesh2()
        dp = _verbs_dp("cuda")
        parts = perftest.build_migratable(mesh, dp, 65_536, VERBS_WINDOW,
                                          credits=VERBS_N)
        _reset_launches()
        qp, _ = parts["init"](dp.runtime_init())
        k = VERBS_N // 2
        out1, qp, _ = parts["xfer"](msgs[:, :k], qp, dp.runtime_init())
        qp, _ = parts["quiesce"](qp, dp.runtime_init())
        snap = verbs.qp_snapshot(qp)
        depth = parts["cfg"].depth
        for key in ("send_ring", "recv_ring"):
            rows = snap[key]
            if rows.shape != (VERBS_RANKS * depth, 65_536) or any(
                    not np.array_equal(rows[r * depth:(r + 1) * depth],
                                       qp[key][r].cpu().numpy())
                    for r in range(VERBS_RANKS)):
                raise AssertionError(f"snapshot {key}: not repro's "
                                     f"(R*depth, slot) layout")
        if snap["cq_head"] != snap["cq_tail"] or \
                snap["sq_head"] != snap["cq_sent"]:
            raise AssertionError("quiesce left the CQ or window open")
        qp2 = verbs.qp_restore(snap, mesh, device="cuda")
        out2, qp2, _ = parts["xfer"](msgs[:, k:], qp2, dp.runtime_init())
        torch.cuda.synchronize()
        res["launches"] += _launches()["bounce"]
        moved = torch.cat([out1[1], out2[1]])
        if not torch.equal(moved, clean[0][1]):
            raise AssertionError("migrated transfer differs from the "
                                 "uninterrupted one")
        _line(f"  verbs migration: {k} of {VERBS_N} messages, quiesce, "
              f"snapshot ({snap['send_ring'].shape} rings), restore, the "
              f"rest: bit for bit the uninterrupted run")

        _reset_launches()
        t0 = time.perf_counter()
        churn = perftest.connection_churn(mesh, device="cuda")[0]
        torch.cuda.synchronize()
        res["launches"] += _launches()["bounce"]
        churn["wall_s"] = time.perf_counter() - t0
        if churn["qps_churned"] < 104 or not churn["bit_identical"] or \
                churn["retransmits"] <= 0:
            raise AssertionError(f"churn {churn}")
        res["churn"] = churn
        _line(f"  verbs churn: {churn}")
        _line("phase 7b verbs loss, migration and churn ok")
    finally:
        if had is None:
            tech._CALIBRATION.pop(probe, None)
        else:
            tech._CALIBRATION[probe] = had
    res["bounce"] = _verbs_bounce_timing()
    return res


def _post_host_us() -> dict:
    """Where a post tick's host time goes: host us per call (no sync) of
    cord's send side on a 64 KiB slice with a runtime state (the kernel
    launch and the counter bumps), without one (the launch alone), and
    one counter bump."""
    import torch
    from repro_torch.core import telemetry as tl
    dp = _verbs_dp("cuda")
    x = torch.zeros(65_536, dtype=torch.uint8, device="cuda")
    rec = tl.OpRecord(kind="verbs", tag="verbs/post", bytes=x.numel(),
                      axes=("rank",), shape=tuple(x.shape), dtype="uint8")
    st = dp.runtime_init()
    out = {"send_side_with_state": _host_us(
               lambda: dp.pipeline.send(x, rec, st, 0)),
           "send_side_no_state": _host_us(
               lambda: dp.pipeline.send(x, rec, None, 0)),
           "counter_bump": _host_us(lambda: tl.tenant_counters_bump(
               st["counters"], 0, ops=1, bytes=x.numel()))}
    _line("  verbs post host us a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out.items()))
    return out


def _verbs_bounce_timing() -> dict:
    """The bounce kernel at one mediated WR's shape: a 4 KiB and a 1 MiB
    uint8 payload with cord's syscall chain, against its plain version and
    ``torch.clone``."""
    import torch
    from repro_torch.core import techniques as tech
    from repro_torch.kernels.dataplane import bounce as bk
    dev = torch.device("cuda")
    iters = tech.iters_for_ns(400.0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = {}
    for label, nbytes in (("4KiB", 4096), ("1MiB", 1 << 20)):
        x = torch.randint(0, 256, (nbytes,), generator=gen, device=dev,
                          dtype=torch.uint8)
        got, gctr = bk.mediated_cost(x, iters, 0)
        want, wctr = bk.mediated_cost_plain(x, iters, 0)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(gctr, wctr)):
            raise AssertionError(f"bounce verbs WR {label} differs from the "
                                 f"plain version")
        call = lambda: bk.mediated_cost(x, iters, 0)  # noqa: E731
        clone = lambda: torch.clone(x)                # noqa: E731
        t_bytes = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        chunks = int(gctr.shape[0])
        t_ops = 2 * chunks * -(-iters // chunks) / F32_FLOPS * 1e3
        out[label] = {
            "bytes": nbytes, "iters": iters,
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "ms": _cuda_ms(call, n=50), "device_ms": _device_ms(call, n=20),
            "host_us": _host_us(call),
            "plain_ms": _wall_ms(lambda: bk.mediated_cost_plain(x, iters, 0),
                                 n=5),
            "library_ms": _cuda_ms(clone, n=50),
            "library_device_ms": _device_ms(clone, n=20),
            "library_host_us": _host_us(clone),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        r = out[label]
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
        _line(f"  bounce verbs WR {label}: {r['ms']:.4f} ms, device "
              f"{fmt(r['device_ms'])} ms, host {r['host_us']:.2f} us/call "
              f"(bound {r['bound_ms']:.6f} ms, {r['bound_by']}); clone "
              f"{r['library_ms']:.4f} ms, device "
              f"{fmt(r['library_device_ms'])}, host "
              f"{r['library_host_us']:.2f} us; plain {r['plain_ms']:.3f} ms")
    return out


def phase_perftest() -> dict:
    """7c: the perftest tables on the card (``run_all(fast=False)``), each
    row printed, then FIG3_REPS repetitions of fig3's BP→BP and CD→CD
    latencies with their medians and spreads."""
    import statistics

    import torch
    from repro_torch.bench import perftest

    _reset_launches()
    t0 = time.perf_counter()
    rows = perftest.run_all(fast=False, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches()["bounce"]
    for row in rows:
        _line("  perftest " + json.dumps(row))
    for row in rows:
        vals = [v for v in row.values() if isinstance(v, float)]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"perftest row not finite: {row}")
    tables = {r["table"] for r in rows}
    need = {"calibration", "fig1", "fig3", "fig4", "window", "credits",
            "churn", "fig5_lat", "fig5_bw"}
    if not need <= tables:
        raise AssertionError(f"perftest tables {tables}, missing "
                             f"{need - tables}")
    sizes = {r["bytes"] for r in rows if r["table"] == "fig1"}
    if sizes != set(perftest.MSG_SIZES):
        raise AssertionError(f"fig1 sizes {sorted(sizes)}")
    for r in rows:
        if r["table"] == "credits" and r["completions"] != 32:
            raise AssertionError(f"credit row lost messages: {r}")
        if r["table"] == "credits" and r["rx_credits"] < 8 and \
                not r["stalls"] > 0:
            raise AssertionError(f"credit starvation without stalls: {r}")
    cal = rows[0]
    preset = perftest.CostPreset(
        "L", syscall_ns=cal["syscall_ns"], interrupt_us=cal["interrupt_us"],
        socket_ns=0.0)
    mesh = perftest.make_mesh2()
    reps = {}
    _reset_launches()
    for transport, op in (("RC", "send"), ("RC", "read"), ("RC", "write"),
                          ("UD", "send")):
        for cm, sm in (("BP", "BP"), ("CD", "CD")):
            mk = lambda m: perftest._dp(  # noqa: E731
                "cord" if m == "CD" else "bypass", emulate=True,
                syscall_ns=preset.syscall_ns,
                interrupt_us=preset.interrupt_us, mesh=mesh, device="cuda")
            lat = [perftest.pingpong_latency_us(mesh, mk(cm), mk(sm), 4096,
                                                iters=20,
                                                transport=transport, op=op)
                   for _ in range(FIG3_REPS)]
            q = statistics.quantiles(lat, n=4)
            reps[f"{transport} {op} {cm}->{sm}"] = {
                "latency_us": lat, "median_us": statistics.median(lat),
                "iqr_us": q[2] - q[0], "range_us": max(lat) - min(lat)}
    torch.cuda.synchronize()
    launches += _launches()["bounce"]
    for key, r in reps.items():
        _line(f"  fig3 x{FIG3_REPS} {key}: median {r['median_us']:.3f} us, "
              f"IQR {r['iqr_us']:.3f}, range {r['range_us']:.3f} "
              f"({', '.join(f'{v:.3f}' for v in r['latency_us'])})")
    _line(f"phase 7c perftest ok: {len(rows)} rows in {secs:.1f} s, "
          f"{launches} bounce launches")
    return {"rows": rows, "fig3_reps": reps, "secs": secs,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 8: timelines and the control plane
# ---------------------------------------------------------------------------

CTL_LENGTHS = (16, 300, 40, 129, 77, 256, 24, 200)   # phase 3's traffic
CTL_RANKS = 4            # 8b's launcher starts on 4 ranks, shrinks to 2
CTL_STEPS = 6
CTL_QUOTA = 1_000_000_000   # bytes: under one step's 4.0 GB of psums
REMESH_LOSS_RTOL = 1e-4  # the quickstart trajectory's tolerance
OBS_CALLS = 1000


def _count_syncs(fn):
    """``fn()`` under the sync debug mode "warn": returns its result and
    the stream synchronisations it made (one warning each)."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def phase_control_serve() -> dict:
    """8a: phase 3's serve with a timeline and without (tokens, samples,
    the artifact, stream syncs a tick), the host cost of a snapshot and of
    a watcher's observe, and ``repro``'s exact-resume budget cycle under
    the serve controller, all at gemma3-1b's full width."""
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import (DataplaneConfig, ElasticConfig,
                                          ServeConfig)
    from repro_torch.core import (CounterTimeline, Dataplane,
                                  ThresholdWatcher, validate_timeline)
    from repro_torch.core import telemetry as tl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import ServeElasticController
    from repro_torch.serve import Engine, Request

    cfg = get_model_config("gemma3-1b")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    mesh = make_mesh((1,), ("data",))

    def dataplane():
        return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                         mesh=mesh, tenant="alice", tenants=("alice", "bob"))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in CTL_LENGTHS]
    scfg = ServeConfig(max_batch=4, kv_cache_len=640, max_new_tokens=16)

    def serve(obs, count: bool):
        eng = Engine(model, params, cfg, scfg, dp=dataplane(), eos_id=-1,
                     obs=obs)
        stamps = []
        real = eng._obs_snapshot

        def stamped(**kw):        # the end of every decode tick
            real(**kw)
            stamps.append(time.perf_counter())

        eng._obs_snapshot = stamped
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        tenant=("alice", "bob")[i % 2])
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        if count:
            done, syncs = _count_syncs(lambda: eng.run(reqs))
        else:
            done, syncs = eng.run(reqs), None
        tick_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return {r.rid: list(r.out_tokens) for r in done}, eng, syncs, \
            tick_ms, len(stamps)

    _reset_launches()
    timeline = CounterTimeline(source="serve/gemma3-1b")
    # the syncs under the debug mode "warn", which records each one
    tok_on, eng_on, syncs_on, _, ticks = serve(timeline, True)
    tok_off, _, syncs_off, _, ticks_off = serve(None, True)
    # the ticks' times apart from it: off, on, on, off
    ms_on, ms_off = [], []
    for on in (False, True, True, False):
        tok, _, _, ms, _ = serve(
            CounterTimeline(source="serve/gemma3-1b") if on else None, False)
        (ms_on if on else ms_off).extend(ms)
        if tok != tok_on:
            raise AssertionError("a timed serve changed the served tokens")
    launches = _launches()
    if tok_on != tok_off or len(tok_on) != len(prompts):
        raise AssertionError("a timeline changed the served tokens")
    if not all(len(t) == 16 and all(0 <= x < cfg.vocab_size for x in t)
               for t in tok_on.values()):
        raise AssertionError("bad tokens")
    ctrs, tenants = eng_on.runtime_counters()
    last = timeline.samples[-1] if timeline.samples else None
    if not (len(timeline.samples) == ticks == ticks_off
            == eng_on._obs_tick_no and last["step"] == ticks
            and last["tenants"] == tl.tenant_counters_report(ctrs, tenants)
            and set(last["gauges"]) == {"active_slots", "queued"}):
        raise AssertionError(f"{len(timeline.samples)} samples for {ticks} "
                             f"ticks; last {last}")
    if syncs_on != syncs_off:
        raise AssertionError(f"stream syncs {syncs_on} with a timeline, "
                             f"{syncs_off} without")
    tmp = tempfile.mkdtemp(prefix="cord_obs_")
    try:
        validate_timeline(CounterTimeline.load(timeline.save(
            os.path.join(tmp, "gemma3-1b_serve_timeline.json"))))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # host cost: one snapshot of the serve counter block, one watcher
    # observe of one new window (OBS_CALLS calls each)
    blk = CounterTimeline(source="blk")
    t0 = time.perf_counter()
    for i in range(OBS_CALLS):
        blk.snapshot_block(i, ctrs, tenants,
                           gauges={"active_slots": 4, "queued": 2})
    snap_us = (time.perf_counter() - t0) * 1e6 / OBS_CALLS
    watcher = ThresholdWatcher({"throttled_pct": 50.0}, sustain=2,
                               cooldown=1, release={"throttled_pct": 10.0})
    obs_tl, spent = CounterTimeline(source="watch"), 0.0
    for i in range(OBS_CALLS + 1):
        obs_tl.snapshot(i, {t: {"ops": 4.0 * i, "throttled": 2.0 * i}
                            for t in ("alice", "bob", "train")}, t=float(i))
        t0 = time.perf_counter()
        watcher.observe(obs_tl)
        spent += time.perf_counter() - t0
    observe_us = spent * 1e6 / OBS_CALLS

    # repro's exact-resume budget cycle (tests/test_control_plane.py)
    sc3 = ServeConfig(max_batch=3, max_new_tokens=10, kv_cache_len=64)

    def requests():
        return [Request(rid=i, prompt=np.asarray((np.arange(8) + 3 * i)
                                                 % 100, np.int32),
                        max_new_tokens=10, tenant="alice") for i in range(3)]

    base = {r.rid: r.out_tokens for r in Engine(
        model, params, cfg, sc3, dp=dataplane(), eos_id=-1).run(requests())}
    cyc_tl = CounterTimeline(source="elastic-serve")
    eng = Engine(model, params, cfg, sc3, dp=dataplane(), eos_id=-1,
                 obs=cyc_tl)
    ctl = ServeElasticController(
        ElasticConfig(enabled=True, shrink_factor=2,
                      thresholds=("throttled_pct=50",),
                      release_thresholds=("throttled_pct=10",)), cyc_tl, eng)
    n = {"tick": 0}

    def hook(_eng):
        n["tick"] += 1
        ev = {"step": n["tick"], "tenant": "alice", "detail": {}}
        if n["tick"] == 3:
            ctl.respond([{**ev, "kind": "trigger"}])
        elif n["tick"] == 14:
            ctl.respond([{**ev, "kind": "recover"}])

    eng.on_tick = hook
    _reset_launches()
    cyc = {r.rid: r.out_tokens for r in eng.run(requests())}
    launches = {k: v + launches[k] for k, v in _launches().items()}
    dirs = [e["detail"]["direction"] for e in cyc_tl.events
            if e["kind"] == "budget"]
    pre = cyc_tl.samples[-1]["tenants"]["alice"]
    if not (cyc == base and all(len(o) == 10 for o in cyc.values())
            and ctl.shrinks == ctl.grows == 1 and eng.slot_budget() == 3
            and dirs == ["shrink", "grow"] and pre["preemptions"] >= 1
            and pre["restores"] >= 1):
        raise AssertionError(f"budget cycle: tokens equal {cyc == base}, "
                             f"shrinks {ctl.shrinks}, grows {ctl.grows}, "
                             f"budget {eng.slot_budget()}, events {dirs}, "
                             f"counters {pre}")
    if launches["bounce"] <= 0 or launches["flash_attention"] <= 0:
        raise AssertionError(f"8a launches {launches}")
    res = {"ticks": ticks, "samples": len(timeline.samples),
           "syncs_on": syncs_on, "syncs_off": syncs_off,
           "syncs_per_tick": syncs_on / ticks,
           "tick_ms_on": statistics.median(ms_on),
           "tick_ms_off": statistics.median(ms_off),
           "snapshot_block_us": snap_us, "observe_us": observe_us,
           "budget_cycle": {"preemptions": pre["preemptions"],
                            "restores": pre["restores"],
                            "samples": len(cyc_tl.samples)},
           "launches": launches}
    _line(f"  8a: {ticks} decode ticks, {len(timeline.samples)} samples, "
          f"tokens identical with the timeline on and off; stream syncs "
          f"{syncs_on} on / {syncs_off} off; tick ms (median of "
          f"{len(ms_on)} / {len(ms_off)}, two serves each, no debug mode) "
          f"{res['tick_ms_on']:.2f} on / {res['tick_ms_off']:.2f} off; "
          f"snapshot_block {snap_us:.2f} us, "
          f"observe {observe_us:.2f} us a call ({OBS_CALLS} calls)")
    _line(f"  8a budget cycle: shrink at tick 3, grow at tick 14, exact "
          f"resume, {pre['preemptions']:.0f} preemptions, "
          f"{pre['restores']:.0f} restores; launches {launches}")
    del model, params, eng, eng_on
    return res


def phase_control_train() -> dict:
    """8b: the flash kernel with its lse against its plain version at the
    per-rank batch of 4 ranks; the launcher with ``--timeline
    --timeline-sink --timeline-rotate --elastic`` at 4 ranks (a remesh to
    2), the same launcher at 4 ranks and at 2 without them (losses: the
    remesh against each rank count throughout), then 3 steps with
    ``--timeline`` and 3 without at 2 ranks (bit identity)."""
    import contextlib
    import dataclasses
    import os
    import shutil
    import statistics
    import tempfile

    import torch
    from repro_torch.configs import get_model_config
    from repro_torch.core import (CounterTimeline, QoSPolicy,
                                  TelemetryPolicy)
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels.dataplane import stall as sk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as launch_train

    # 4 ranks give each rank one sequence: the lse kernel at B=1 (2 ranks
    # after the remesh give phase 5a's B=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    flash_b1 = [_flash_lse_case(gen, TRAIN_BATCH // CTL_RANKS, window)
                for window in (512, 0)]

    real_dp, real_loop = launch_train.Dataplane, launch_train.run_loop
    real_ctl = launch_train.ElasticController
    built: list = []
    per_step: list = []
    timing = {"drive_ms": [], "build_ms": []}

    def converged_dp(cfg, mesh=None, policies=None, device=None, **kw):
        """phase 5's dataplane: cost emulation and the tenant's QoS
        bucket, beside the launcher's own policies."""
        pol = list(policies) if policies is not None else [TelemetryPolicy()]
        if not any(isinstance(p, QoSPolicy) for p in pol):
            pol.append(QoSPolicy(rates={"default": 0.25}, burst=2.0,
                                 stall_ns=200.0))
        t0 = time.perf_counter()
        dp = real_dp(dataclasses.replace(cfg, emulate_costs=True), mesh=mesh,
                     policies=pol, device=device, **kw)
        timing["build_ms"].append((time.perf_counter() - t0) * 1e3)
        built.append(dp)
        return dp

    def counted_loop(step_fn, *a, **kw):
        def counted(s, b):
            n0 = {**_launches(), "flash_lse": fa.LSE_LAUNCHES}
            out = step_fn(s, b)
            per_step.append({k: v - n0[k] for k, v in
                             {**_launches(),
                              "flash_lse": fa.LSE_LAUNCHES}.items()})
            return out
        return real_loop(counted, *a, **kw)

    class TimedController(real_ctl):
        def drive(self, state, step):
            t0 = time.perf_counter()
            out = super().drive(state, step)
            timing["drive_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

    tmp = tempfile.mkdtemp(prefix="cord_ctl_")
    cwd = os.getcwd()
    sink = os.path.join(tmp, "sink.jsonl")
    size = [f"steps={CTL_STEPS}", f"seq_len={TRAIN_SEQ}",
            f"global_batch={TRAIN_BATCH}", "log_every=1"]
    elastic = ["--timeline", "--timeline-sink", sink, "--timeline-rotate",
               "1024", "--elastic", f"elastic.meter_quota_bytes={CTL_QUOTA}",
               "elastic.thresholds=denied_pct=50", "elastic.sustain=2",
               "elastic.cooldown=1", "elastic.min_devices=2"]
    launch_train.Dataplane = converged_dp
    launch_train.run_loop = counted_loop
    launch_train.ElasticController = TimedController
    try:
        os.chdir(tmp)
        with open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull):
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            fa.LSE_LAUNCHES = 0
            state, rep = launch_train.main(["--full", "--ranks",
                                            str(CTL_RANKS), *elastic, *size])
            del state
            launches = {**_launches(), "flash_lse": fa.LSE_LAUNCHES}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            el_steps, el_ms = list(per_step), [t * 1e3 for t in rep.step_times]
            losses = [m["loss"] for m in rep.metrics]
            doc = CounterTimeline.load("runs/torch/gemma3-1b_timeline.json")
            back = CounterTimeline.read_rotated(sink)
            rotations = sum(1 for f in os.listdir(tmp)
                            if f.startswith("sink.jsonl."))
            del rep
            gc.collect()
            torch.cuda.empty_cache()
            state, rep = launch_train.main(["--full", "--ranks",
                                            str(CTL_RANKS), *size])
            base = [m["loss"] for m in rep.metrics]
            del state, rep
            gc.collect()
            torch.cuda.empty_cache()
            state, rep = launch_train.main(["--full", "--ranks",
                                            str(CTL_RANKS // 2), *size])
            base2 = [m["loss"] for m in rep.metrics]
            del state, rep
            gc.collect()
            torch.cuda.empty_cache()
            per_step.clear()
            short = ["--full", "--ranks", "2", "steps=3",
                     f"seq_len={TRAIN_SEQ}", f"global_batch={TRAIN_BATCH}"]
            s_on, rep_on = launch_train.main(["--timeline", *short])
            s_off, rep_off = launch_train.main(short)
    finally:
        os.chdir(cwd)
        launch_train.Dataplane, launch_train.run_loop = real_dp, real_loop
        launch_train.ElasticController = real_ctl
    differ = [p for (p, a), (_, b) in zip(
        tree_flatten({"params": s_on.params, "mu": s_on.opt.mu,
                      "nu": s_on.opt.nu}),
        tree_flatten({"params": s_off.params, "mu": s_off.opt.mu,
                      "nu": s_off.opt.nu}))
        if not torch.equal(_bits(a), _bits(b))]
    on_ms = [t * 1e3 for t in rep_on.step_times]
    off_ms = [t * 1e3 for t in rep_off.step_times]
    del s_on, s_off
    gc.collect()
    torch.cuda.empty_cache()

    kinds = [e["kind"] for e in doc["events"]]
    remesh = next(e for e in doc["events"] if e["kind"] == "remesh")
    ops = [s["tenants"]["default"]["ops"] for s in doc["samples"]]
    psums = [b - a for a, b in zip([0.0] + ops, ops)]
    at = remesh["step"]
    ranks = [CTL_RANKS if i < at else CTL_RANKS // 2
             for i in range(CTL_STEPS)]
    per_psum = [st["bounce"] / n for st, n in zip(el_steps, psums)]
    stall_per = [st["bounce_stall"] / n for st, n in zip(el_steps, psums)]
    layers = get_model_config(TRAIN_ARCH).num_layers
    lse_per = [st["flash_lse"] / layers for st in el_steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
    # the cause of a gap: the rank count (2 against 4 throughout) or the
    # move (the remesh run against 2 ranks throughout, after the move)
    rel_ranks = [abs(a - b) / abs(b) for a, b in zip(base2, base)]
    rel_moved = [abs(a - b) / abs(b) for a, b in zip(losses, base2)]
    if kinds != ["trigger", "remesh", "trigger", "remesh-skipped"] or not (
            remesh["detail"]["direction"] == "shrink"
            and remesh["detail"]["devices_before"] == CTL_RANKS
            and remesh["detail"]["devices_after"] == CTL_RANKS // 2
            and "max_remesh" in doc["events"][-1]["detail"]["reason"]):
        raise AssertionError(f"8b events {doc['events']}")
    if per_psum != ranks or stall_per != ranks or lse_per != ranks:
        raise AssertionError(f"8b launches per psum {per_psum} (stall "
                             f"{stall_per}, flash with lse {lse_per}), want "
                             f"{ranks}")
    if len(losses) != CTL_STEPS or max(rel) > REMESH_LOSS_RTOL:
        raise AssertionError(f"8b losses {losses} against {base}: rel {rel}")
    if losses[:at] != base[:at]:
        raise AssertionError(f"8b losses before the move {losses[:at]} are "
                             f"not those of 4 ranks throughout {base[:at]}")
    if back.samples != doc["samples"] or back.events != doc["events"] or \
            rotations < 1:
        raise AssertionError(f"the rotated sink ({rotations} segments) "
                             f"reads back other samples or events")
    if differ:
        raise AssertionError(f"--timeline changed {differ}")

    # one snapshot on the card: the counter block's device-to-host read
    # and the sample, OBS_CALLS of them; then the QoS stall's host time
    dp = built[-1]
    rt = dp.runtime_init()
    tl_ = CounterTimeline(source="snap")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(OBS_CALLS):
        tl_.snapshot(i, dp.runtime_report(rt))
    snap_ms = (time.perf_counter() - t0) * 1e3 / OBS_CALLS
    one = torch.zeros(1, device="cuda")
    trip = torch.full((), 1, dtype=torch.int32, device="cuda")
    stall_host_us = _host_us(lambda: sk.stall(one, trip), n=OBS_CALLS)
    shutil.rmtree(tmp, ignore_errors=True)
    res = {"flash_lse_b1": flash_b1,
           "lse_b1_worst_err": max(r["lse_err"] for r in flash_b1),
           "losses": losses, "baseline_losses": base, "loss_rel": rel,
           "ranks2_losses": base2, "loss_rel_ranks2_vs_4": rel_ranks,
           "loss_rel_remesh_vs_ranks2": rel_moved,
           "events": kinds, "remesh_step": at,
           "launches_per_step": el_steps, "bounce_per_psum": per_psum,
           "launches": launches, "step_ms": el_ms, "peak_gb": peak_gb,
           "drive_ms": timing["drive_ms"],
           "dataplane_build_ms": timing["build_ms"],
           "sink_segments": rotations + 1,
           "step_ms_timeline_on": on_ms, "step_ms_timeline_off": off_ms,
           "step_ms_on_median": statistics.median(on_ms),
           "step_ms_off_median": statistics.median(off_ms),
           "snapshot_ms": snap_ms, "stall_host_us": stall_host_us}
    fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs)  # noqa: E731
    _line(f"  8b: events {kinds}; remesh {CTL_RANKS} -> {CTL_RANKS // 2} "
          f"ranks at step {at}; bounce launches per psum {per_psum}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} (max rel "
          f"{max(rel):.2e} against 4 ranks throughout, equal before the "
          f"move); 2 ranks throughout against 4: rel "
          f"{', '.join(f'{x:.2e}' for x in rel_ranks)}; the remesh run "
          f"against 2 ranks throughout: rel "
          f"{', '.join(f'{x:.2e}' for x in rel_moved)}; step ms "
          f"{fmt(el_ms)}; drive ms {fmt(timing['drive_ms'])}; peak "
          f"{peak_gb:.2f} GB; sink in {rotations + 1} segments")
    _line(f"  8b: 3 steps at 2 ranks, --timeline on / off: step ms "
          f"{fmt(on_ms)} / {fmt(off_ms)}, params and moments bit for bit; "
          f"one snapshot {snap_ms:.4f} ms; stall host {stall_host_us:.2f} "
          f"us a call")
    return res


def phase_control_pod() -> dict:
    """8c: the pod storyline (``bench.control_plane.control_plane_smoke``)
    with host 1's engine on full-width gemma3-1b, then ``elastic_smoke``;
    both hold their own gates and raise on a miss."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from repro_torch.bench import control_plane

    tmp = tempfile.mkdtemp(prefix="cord_pod_")
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            pod = control_plane.control_plane_smoke(
                device="cuda", smoke=False,
                out_path=os.path.join(tmp, "control_plane_timeline.json"))
            el = control_plane.elastic_smoke(
                device="cuda",
                out_path=os.path.join(tmp, "elastic_timeline.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    launches = _launches()
    if launches["bounce"] <= 0 or launches["flash_attention"] <= 0:
        raise AssertionError(f"8c launches {launches}")
    doc = pod["doc"]
    events = [(e["kind"], e["detail"].get("direction"))
              for e in doc["events"] if e["kind"] in ("remesh", "budget")]
    _line(f"  8c: storyline {pod['storyline']}; moves {events}; elastic "
          f"smoke trigger at step {el['trigger_step']}; migrations bit for "
          f"bit; launches {launches}; {secs:.1f} s")
    return {"storyline": pod["storyline"], "moves": events,
            "elastic_trigger_step": el["trigger_step"],
            "launches": launches, "secs": secs}


def phase_control() -> dict:
    """Phase 8: 8a, 8b and 8c, with the kernels' launches of each."""
    import torch
    t0 = time.perf_counter()
    serve = phase_control_serve()
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_control_train()
    gc.collect()
    torch.cuda.empty_cache()
    pod = phase_control_pod()
    secs = time.perf_counter() - t0
    _line(f"phase 8 control plane ok in {secs:.1f} s")
    return {"serve": serve, "train": train, "pod": pod, "secs": secs}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one full-width prefill and decode tick "
                         "of each model")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    bounce = phase_bounce()
    flash = phase_flash()
    ssm = phase_ssm()
    serve, prof = {}, {}
    for arch, phase in (("gemma3-1b", "3"), ("hymba-1.5b", "4")):
        res = phase_serve(arch, phase)
        inputs = res.pop("_profile_inputs")
        if args.profile:
            prof[arch] = profile_serve(*inputs)
        serve[arch] = res
        if arch == "gemma3-1b":
            serve["gemma3-1b-paged"] = phase_serve_paged(*inputs)
        del inputs, res                # free this model before the next
        gc.collect()
        torch.cuda.empty_cache()
    train_k = phase_train_kernels()
    train = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    gspmd = phase_train_gspmd()
    launcher = phase_launcher()
    cpsum = phase_chunked_psum()
    gc.collect()
    torch.cuda.empty_cache()
    verbs = phase_verbs()
    perf = phase_perftest()
    gc.collect()
    torch.cuda.empty_cache()
    control = phase_control()

    def main_path_launches(name):
        return sum(r["launches"][name] for r in serve.values())

    table = bounce["table_1.21GB"]
    main_flash = next(r for r in flash["cases"]
                      if r["model"] == "gemma3-1b" and r["s"] == 512
                      and r["window"] == 0 and r["logit_cap"] == 0.0)
    main_ssm = next(r for r in ssm["cases"]
                    if r["shape"] == [1, 300, 3200, 16]
                    and r["dtype"] == "float32")
    kernels = [
        {"name": "bounce", "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/kernels/dataplane/bounce.py:76",
         "launches": main_path_launches("bounce"),
         "max_abs_err": bounce["max_abs_err"],
         "ms": table["ms"], "device_ms": table["device_ms"],
         "plain_ms": table["plain_ms"],
         "bound_ms": table["bound_ms"], "bound_by": "bytes",
         "library_ms": table["library_ms"],
         "library_device_ms": table["library_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": main_path_launches("flash_attention"),
         "max_abs_err": flash["worst_bf16_err"], "ms": main_flash["ms"],
         "device_ms": main_flash["device_ms"],
         "plain_ms": main_flash["plain_ms"],
         "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"],
         "library_ms": main_flash["library_ms"],
         "library_device_ms": main_flash["library_device_ms"]},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:30",
         "launches": main_path_launches("ssm_scan"),
         "max_abs_err": ssm["worst_f32_err"], "ms": main_ssm["ms"],
         "device_ms": main_ssm["device_ms"],
         "plain_ms": main_ssm["plain_ms"], "bound_ms": main_ssm["bound_ms"],
         "bound_by": main_ssm["bound_by"], "library_ms": None},
    ]
    # phase 5's path: the train step's launches, at the train shapes
    lse_main = train_k["flash_lse"][0]          # window 512: 5 of 6 layers
    stall_iters = train["stall_iters"]
    kernels += [
        {"name": "bounce (train: gradient psums)", "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/kernels/dataplane/bounce.py:76",
         "launches": train["launches"]["bounce"],
         "max_abs_err": train["psum_bounce_err"],
         "ms": train["psum_bounce_ms"],
         "device_ms": train["psum_bounce_device_ms"],
         "plain_ms": train["psum_bounce_plain_ms"],
         "bound_ms": train["psum_bounce_bound_ms"], "bound_by": "bytes",
         "library_ms": train["psum_clone_ms"]},
        {"name": "flash_attention (train forward with lse)", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": train["launches"]["flash_lse"],
         "max_abs_err": train_k["lse_worst_err"], "ms": lse_main["ms"],
         "device_ms": lse_main["device_ms"], "plain_ms": lse_main["plain_ms"],
         "bound_ms": lse_main["bound_ms"], "bound_by": lse_main["bound_by"],
         "library_ms": train_k["flash_lse"][1]["library_ms"]},
        {"name": "bounce_stall (QoS stall)", "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/core/techniques.py:75 (delay_chain_dyn, an "
                     "XLA loop beside the Pallas kernel)",
         "launches": train["launches"]["bounce_stall"], "max_abs_err": 0.0,
         "ms": train["stall_ms"], "plain_ms": train["stall_plain_ms"],
         "bound_ms": 2 * stall_iters / F32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
    ]
    # phase 6a's path: the GSPMD step's constraint edges and flash forwards
    edge, f4 = gspmd["logits_edge"], gspmd["flash_lse_b4"]
    kernels += [
        {"name": "bounce (train GSPMD: constraint edges; timed on the "
                 "loss/logits edge)", "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/kernels/dataplane/bounce.py:76",
         "launches": gspmd["launches"]["bounce"],
         "max_abs_err": edge["max_abs_err"], "ms": edge["ms"],
         "plain_ms": edge["plain_ms"], "bound_ms": edge["bound_ms"],
         "bound_by": "bytes", "library_ms": edge["library_ms"]},
        {"name": "flash_attention (train GSPMD forward with lse, B=4)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": gspmd["launches"]["flash_lse"],
         "max_abs_err": f4["lse_err"], "ms": f4["ms"],
         "device_ms": f4["device_ms"], "plain_ms": f4["plain_ms"],
         "bound_ms": f4["bound_ms"], "bound_by": f4["bound_by"],
         "library_ms": f4["library_ms"]},
    ]
    # phase 7's path: every mediated WR of the verbs transport and perftest
    vb = verbs["bounce"]
    small = vb["4KiB"]
    kernels.append(
        {"name": "bounce (verbs: per-WR mediation)", "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/kernels/dataplane/bounce.py:76",
         "launches": verbs["launches"] + perf["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in vb.values()),
         "ms": small["ms"], "device_ms": small["device_ms"],
         "host_us": small["host_us"], "plain_ms": small["plain_ms"],
         "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
         "library_ms": small["library_ms"],
         "library_device_ms": small["library_device_ms"],
         "at_1MiB": vb["1MiB"]})
    # phase 8's path: the control loop's serve, train and pod runs
    c_serve, c_train, c_pod = (control["serve"], control["train"],
                               control["pod"])
    lse_b1 = c_train["flash_lse_b1"][0]          # window 512: 5 of 6 layers
    c_launch = {k: c_serve["launches"][k] + c_train["launches"][k]
                + c_pod["launches"][k] for k in c_serve["launches"]}
    kernels += [
        {"name": "bounce (control plane: 8a serve, 8b psums across the "
                 "remesh, 8c pod; timed on phase 5's psums)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/kernels/dataplane/bounce.py:76",
         "launches": c_launch["bounce"],
         "max_abs_err": train["psum_bounce_err"],
         "ms": train["psum_bounce_ms"],
         "device_ms": train["psum_bounce_device_ms"],
         "plain_ms": train["psum_bounce_plain_ms"],
         "bound_ms": train["psum_bounce_bound_ms"], "bound_by": "bytes",
         "library_ms": train["psum_clone_ms"]},
        {"name": "flash_attention (control plane: 8a prefills, 8b forward "
                 "with lse; timed on 8b's B=1 at 4 ranks, window 512)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
         "launches": c_launch["flash_attention"],
         "max_abs_err": max(c_train["lse_b1_worst_err"],
                            train_k["lse_worst_err"]),
         "ms": lse_b1["ms"], "device_ms": lse_b1["device_ms"],
         "plain_ms": lse_b1["plain_ms"], "bound_ms": lse_b1["bound_ms"],
         "bound_by": lse_b1["bound_by"],
         "library_ms": c_train["flash_lse_b1"][1]["library_ms"]},
        {"name": "bounce_stall (QoS stall; control plane: 8b)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/dataplane/csrc/bounce.cu",
         "replaces": "src/repro/core/techniques.py:75 (delay_chain_dyn, an "
                     "XLA loop beside the Pallas kernel)",
         "launches": c_launch["bounce_stall"], "max_abs_err": 0.0,
         "ms": train["stall_ms"], "host_us": c_train["stall_host_us"],
         "plain_ms": train["stall_plain_ms"],
         "bound_ms": 2 * stall_iters / F32_FLOPS * 1e3,
         "bound_by": "operations", "library_ms": None},
    ]
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                   "cuda": torch.version.cuda,
                                   "bounce": bounce, "flash": flash,
                                   "ssm_scan": ssm, "serve": serve,
                                   "train_kernels": train_k, "train": train,
                                   "gspmd": gspmd, "launcher": launcher,
                                   "chunked_psum": cpsum,
                                   "verbs": verbs, "perftest": perf,
                                   "control": control,
                                   "profile": prof or None,
                                   "kernels": kernels},
                                  indent=1))
    _line(f"chip_smoke: every phase ok in {time.perf_counter() - t_start:.1f}"
          f" s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
