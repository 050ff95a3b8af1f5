#!/usr/bin/env python3
"""Time the port's kernels of several checkouts on one card.

    python3 tools/kernel_ab.py ROOT [ROOT ...] [--out results.json]
        [--edits cuts.json] [--backward-only] [--f32-only]

Each ROOT is a checkout of this repository (its ``src/`` holds
``repro_torch``).  The roots run one after another, each in a fresh
process that builds its own kernels into ``ROOT/build/kernels``, so two
commits are compared on the same card in one call; give them in turns
(parent, change, change, parent).  ``ROOT@LABEL`` times a scratch copy
of ROOT's ``src/`` with one edit of ``--edits`` applied (a JSON object:
label -> {"source": path under ``src/repro_torch``, "old": text found
there exactly once, "new": its replacement}), so that cut-down copies of
a kernel are timed beside the kernel itself in one call; for example
``{"no_exp": {"source": "kernels/ssm_scan/csrc/ssm_scan.cu", "old":
"fr[i][s] = exp_bwd<kFar>(dtv * an[s], sm.table);", "new": "fr[i][s] =
1.0 + dtv * an[s];"}}`` times ``ROOT@no_exp``, the backward's gradient
kernel with its rescan's factors cut to 1 + dt a.  A root that fails
is reported and the rest run.  For each root it prints, and writes to
``--out``, at the main path's shapes:

* bounce (``mediated_cost`` with cord's 400 ns syscall delay, copies 0)
  and ``torch.clone`` on the 1.21 GB gemma3-1b f32 table, a bf16
  (1, 512, 1152) activation and a 64 KB payload: CUDA-event ms per call,
  profiler device ms per call, and host us per call (1,000 calls with no
  synchronisation between them) for the two small payloads;
* ssm_scan at hymba-1.5b shapes (d_inner 3200, N 16, f32): prefill
  S = 300 and 2048 and the 4-slot decode tick: event ms, device ms, and
  host us per call at decode;
* the backward kernels at the train shapes: ``ssm_scan_bwd`` at a rank's
  hymba-1.5b 2 x 256 (mamba's dt and A; f32 and bf16 dt/x) and at the
  GSPMD step's 4 x 256 (f32), and ``flash_attention_bwd``
  (bf16) at gemma3-1b's B=2, 4 and 1 S=256 window 512 (the explicit-DP,
  GSPMD and launcher steps), hymba-1.5b's 25 over 5
  heads, D 64, window 1024, whisper-small's encoder (1 x 1,500, 12
  heads, D 64, not causal) and cross attention (256 x 1,500), and
  grok-1's 48 over 8 heads, D 128, soft cap 30 at B=1 S=256: event ms,
  device ms, host us per call (100 calls) and each CUDA kernel's device
  us per call.  A root whose wrappers have no backward kernel reports
  them as absent;
* flash attention's f32 path at the examples' shapes (``chip_smoke.py``
  phase 11): the forward at 11a (the smoke gemma3's 4 over 1 heads, D 16,
  window 8, B=2 S=64, with lse), 11b (B=1 S=16, no lse) and 11c
  (train_lm's 8 over 4 heads, D 64, B=2 S=256, with lse), each beside the
  library call phase 11 times there (SDPA with the mask without lse,
  else ATen's efficient attention, a binding window as an additive
  bias), and the backward at 11a and 11c beside ATen's efficient
  attention backward on the same inputs and bias: for the kernel and the
  library alike, event ms, device ms, host us per call (100 calls) and
  each CUDA kernel's device us per call.

``--backward-only`` times the bf16 and scan backward kernels alone,
``--f32-only`` the f32 flash rows alone.  Every number names the card
and its power limit.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def worker(root: str, backward_only: bool = False,
           f32_only: bool = False) -> dict:
    """The measurements of one checkout, in this process."""
    # chip_smoke's timing helpers; it puts this checkout's src on the
    # path, so the measured root's src goes in front of it afterwards
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _cuda_ms, _device_ms, _host_us
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.core import techniques as tech
    from repro_torch.kernels.dataplane import bounce as bk
    from repro_torch.kernels.ssm_scan import ops as ssm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"root": root, "bounce": {}, "ssm_scan": {}, "backward": {},
           "f32": {}}
    if f32_only:
        out["f32"] = _f32(gen, dev)
        return out
    if backward_only:
        out["backward"] = _backward(gen, dev)
        return out
    iters = tech.iters_for_ns(400.0, device=dev)
    out.update(ns_per_iter=tech.calibrate(device=dev), syscall_iters=iters)
    for label, shape, dtype in (
            ("table_1.21GB", (262_144, 1152), torch.float32),
            ("act_1x512x1152_bf16", (1, 512, 1152), torch.bfloat16),
            ("64KB", (16_384,), torch.float32)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        call = lambda: bk.mediated_cost(x, iters, 0)  # noqa: E731
        clone = lambda: torch.clone(x)                # noqa: E731
        row = {"ms": _cuda_ms(call, n=20), "device_ms": _device_ms(call),
               "clone_ms": _cuda_ms(clone, n=20),
               "clone_device_ms": _device_ms(clone)}
        if label != "table_1.21GB":
            row["host_us"] = _host_us(call)
            row["clone_host_us"] = _host_us(clone)
        out["bounce"][label] = row
        del x
    for label, shape in (("prefill_300", (1, 300, 3200, 16)),
                         ("prefill_2048", (1, 2048, 3200, 16)),
                         ("decode", (4, 1, 3200, 16))):
        bsz, s, di, n = shape
        rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
        args = (F.softplus(rnd(bsz, s, di)), rnd(bsz, s, di),
                -torch.exp(rnd(di, n) * 0.3), rnd(bsz, s, n), rnd(bsz, s, n),
                rnd(bsz, di, n))
        call = lambda: ssm.ssm_scan(*args)  # noqa: E731
        row = {"ms": _cuda_ms(call, n=20), "device_ms": _device_ms(call)}
        if label == "decode":
            row["host_us"] = _host_us(call)
        out["ssm_scan"][label] = row
    out["backward"] = _backward(gen, dev)
    out["f32"] = _f32(gen, dev)
    return out


def _by_kernel(fn, n: int = 10) -> dict:
    """Device us per call of each CUDA kernel ``fn`` launches (profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {_kernel_name(e.key): e.self_device_time_total / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _kernel_name(key: str) -> str:
    """A CUDA kernel's short name: "void (anonymous namespace)::kern<T,
    16>(args)" as "kern<T, 16>", "fmha_cutlassF_f32_..._sm80(args)" as
    itself without its arguments."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    depth, cut = 0, len(key)
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    head, depth, start = key[:cut], 0, 0
    for i, ch in enumerate(head):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and head.startswith("::", i):
            start = i + 2
    return head[start:]


def _backward(gen, dev) -> dict:
    """The backward kernels at the train shapes; absent from a root whose
    wrappers have none."""
    import math

    import torch
    from chip_smoke import _cuda_ms, _device_ms, _host_us
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as ssm

    rows = {}
    # label: (B, S, di, N, dt/x dtype); a rank's explicit-DP shape, the
    # GSPMD step's, and the first in bf16
    for label, (bsz, s, di, n, dtype) in (
            ("ssm_scan_bwd_2x256", (2, 256, 3200, 16, torch.float32)),
            ("ssm_scan_bwd_4x256", (4, 256, 3200, 16, torch.float32)),
            ("ssm_scan_bwd_2x256_bf16", (2, 256, 3200, 16, torch.bfloat16))):
        if not hasattr(ssm, "ssm_scan_bwd"):
            rows[label] = "absent"
            continue
        u = torch.rand(bsz, s, di, generator=gen, device=dev)
        rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
        args = (torch.exp(math.log(1e-3) + u * math.log(100.0)).to(dtype),
                rnd(bsz, s, di).to(dtype),
                -torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                .expand(di, n).contiguous(), rnd(bsz, s, n), rnd(bsz, s, n),
                rnd(bsz, di, n), rnd(bsz, s, di).to(dtype), rnd(bsz, di, n))
        call = lambda: ssm.ssm_scan_bwd(*args)  # noqa: E731
        rows[label] = {"ms": _cuda_ms(call, n=20),
                       "device_ms": _device_ms(call),
                       "host_us": _host_us(call, n=100),
                       "kernel_us": _by_kernel(call)}
        del args
    # label: (B, Sq, Skv, H, KVH, D, causal, window, logit_cap)
    for label, (b, sq, skv, h, kvh, d, causal, window, cap) in (
            ("flash_bwd_gemma3_w512", (2, 256, 256, 4, 1, 256, True, 512,
                                       0.0)),
            ("flash_bwd_gemma3_b4_w512", (4, 256, 256, 4, 1, 256, True, 512,
                                          0.0)),
            ("flash_bwd_gemma3_b1_w512", (1, 256, 256, 4, 1, 256, True, 512,
                                          0.0)),
            ("flash_bwd_hymba_w1024", (2, 256, 256, 25, 5, 64, True, 1024,
                                       0.0)),
            ("flash_bwd_whisper_encoder", (1, 1500, 1500, 12, 12, 64, False,
                                           0, 0.0)),
            ("flash_bwd_whisper_cross", (1, 256, 1500, 12, 12, 64, False, 0,
                                         0.0)),
            ("flash_bwd_grok_cap30", (1, 256, 256, 48, 8, 128, True, 0,
                                      30.0))):
        if not hasattr(fa, "flash_attention_bwd"):
            rows[label] = "absent"
            continue
        q, do = (torch.randn(b, sq, h, d, generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, skv, kvh, d, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                    logit_cap=cap, return_lse=True)
        call = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, window=window,
            logit_cap=cap)
        rows[label] = {"ms": _cuda_ms(call, n=20),
                       "device_ms": _device_ms(call),
                       "host_us": _host_us(call, n=100),
                       "kernel_us": _by_kernel(call)}
    return rows

# label: (B, S, H, KVH, D, window, lse): chip_smoke.py phase 11's f32
# flash cases (11a quickstart, 11b serve_lm, 11c train_lm)
F32_CASES = (("f32_11a", (2, 64, 4, 1, 16, 8, True)),
             ("f32_11b", (1, 16, 4, 1, 16, 8, False)),
             ("f32_11c", (2, 256, 8, 4, 64, 0, True)))


def _timed(call) -> dict:
    from chip_smoke import _cuda_ms, _device_ms, _host_us
    return {"ms": _cuda_ms(call, n=20), "device_ms": _device_ms(call),
            "host_us": _host_us(call, n=100), "kernel_us": _by_kernel(call)}


def _f32(gen, dev) -> dict:
    """Flash attention's f32 forward and backward at phase 11's shapes,
    each beside the library call that computes the same function."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    rows = {}
    for label, (b, s, h, kvh, d, window, lse) in F32_CASES:
        q = 3 * torch.randn(b, s, h, d, generator=gen, device=dev)
        k = torch.randn(b, s, kvh, d, generator=gen, device=dev)
        v = torch.rand(b, s, kvh, d, generator=gen, device=dev) * 3 - 1.5
        do = torch.randn(b, s, h, d, generator=gen, device=dev)
        kw = dict(window=window, return_lse=lse)
        fwd = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        qt, dot = (t.transpose(1, 2).contiguous() for t in (q, do))
        kt, vt = (t.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
                  .contiguous() for t in (k, v))
        pos = torch.arange(s, device=dev)
        mask = pos[None] <= pos[:, None]
        if window:
            mask &= pos[:, None] - pos[None] < window
        bias = None
        if window and window < s:
            bias = torch.zeros(s, s, device=dev).masked_fill(
                ~mask, float("-inf")).expand(b, h, s, s).contiguous()
        if not lse:
            lib_name = "sdpa_mask"
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        else:
            lib_name = "aten_efficient_attention"
            eff = torch.ops.aten._scaled_dot_product_efficient_attention
            lib = lambda: eff(qt, kt, vt, bias, True, 0.0,  # noqa: E731
                              bias is None)
        rows[f"{label}_fwd"] = {"kernel": _timed(fwd), "library": lib_name,
                                lib_name: _timed(lib)}
        if not lse:
            continue
        o, lse_k = fwd()
        bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse_k, do, window=window)
        out, lse_a, seed, off = eff(qt, kt, vt, bias, True, 0.0,
                                    bias is None)
        eff_bwd = \
            torch.ops.aten._scaled_dot_product_efficient_attention_backward
        lib_bwd = lambda: eff_bwd(  # noqa: E731
            dot, qt, kt, vt, bias, out, lse_a, seed, off, 0.0,
            [True, True, True, False], bias is None)
        rows[f"{label}_bwd"] = {
            "kernel": _timed(bwd),
            "library": "aten_efficient_attention_backward",
            "aten_efficient_attention_backward": _timed(lib_bwd)}
    return rows


def _edited(root: str, edits: dict, tmp: pathlib.Path) -> pathlib.Path:
    """A scratch copy of ``root``'s ``src/`` (for ``root@label``) with the
    edit ``label`` applied; raises unless its text is there exactly once."""
    base, label = root.rsplit("@", 1)
    if label not in edits:
        raise SystemExit(f"no edit {label!r} in --edits; known: "
                         f"{sorted(edits)}")
    edit = edits[label]
    shutil.copytree(pathlib.Path(base).resolve() / "src", tmp / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp / "src" / "repro_torch" / edit["source"]
    text = path.read_text()
    if text.count(edit["old"]) != 1:
        raise SystemExit(f"{label}: the text to replace is not in "
                         f"{edit['source']} exactly once")
    path.write_text(text.replace(edit["old"], edit["new"]))
    return tmp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out", default="")
    ap.add_argument("--backward-only", action="store_true",
                    help="time the backward kernels alone")
    ap.add_argument("--f32-only", action="store_true",
                    help="time the f32 flash forward and backward alone")
    ap.add_argument("--edits", default="",
                    help="JSON file of the edits that ROOT@LABEL applies")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.backward_only,
                                args.f32_only)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    edits = json.loads(pathlib.Path(args.edits).read_text()) \
        if args.edits else {}
    flags = (["--backward-only"] if args.backward_only else []) + \
        (["--f32-only"] if args.f32_only else [])
    runs, failed = [], False
    for root in args.roots:
        with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
            path = _edited(root, edits, pathlib.Path(tmp)) \
                if "@" in root else pathlib.Path(root).resolve()
            r = subprocess.run([sys.executable, __file__, "--worker",
                                str(path)] + flags,
                               capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:        # reported, and the next root runs
            print(f"{root}: failed\n{r.stderr[-3000:]}", flush=True)
            runs.append({"root": root, "error": r.stderr[-3000:]})
            failed = True
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["root"] = root
        runs.append(res)
        b, s = res["bounce"], res["ssm_scan"]
        print(f"{root}:" + (f" slope {res['ns_per_iter']:.4f} ns/iter"
                            if "ns_per_iter" in res else ""), flush=True)
        for label, row in b.items():
            print(f"  bounce {label}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if v is not None),
                flush=True)
        for label, row in s.items():
            print(f"  ssm_scan {label}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if v is not None),
                flush=True)
        for label, row in res["backward"].items():
            print(f"  {label}: " + (row if isinstance(row, str) else ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items() if v is not None)), flush=True)
        for label, row in res["f32"].items():
            for who in ("kernel", row["library"]):
                print(f"  {label} {who}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row[who].items() if v is not None),
                    flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
