"""Serve waves of requests through the port's engine and dataplane.

Set-up makes the weights from the seed, builds the model, the cord
dataplane and the engine as the mix states them, and serves one request
of every prompt shape the mix can produce.  The window then submits
wave after wave: each wave's requests go to `Engine.run` at once, and the
next wave is submitted when it returns; the window closes when the wave
that returns after `--seconds` does.  Every output token is stamped when
the engine appends it.  Once the window has closed and the engine is
gone, the plain reference recomputes a sample of the served requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cordbench import check, flops, stats, traffic_gen, weights
from cordbench.common import Outcome, log, peak_bytes, release
from cordbench.reference import moe_lm
from cordbench.reference.common import Precision, float32_exact
from cordbench.trace import Profiled, Spans, spanned_model

REFERENCES = {"moe": moe_lm.logits_at}


class Stamps(list):
    """A request's output tokens, each stamped (perf_counter) when the
    engine appends it."""

    def __init__(self):
        super().__init__()
        self.at: list[float] = []

    def append(self, token):
        self.at.append(time.perf_counter())
        super().append(token)


def build(ctx, params):
    """The model, dataplane and engine the mix states, around ``params``;
    with tracing, the model's serving calls run in spans."""
    from repro_torch.configs.base import DataplaneConfig, ServeConfig
    from repro_torch.core import Dataplane
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    mix = ctx.cell.mix
    cfg = ctx.cell.model_config()
    d = mix["dataplane"]
    dp = Dataplane(DataplaneConfig(mode=d["mode"],
                                   emulate_costs=d["emulate_costs"]),
                   mesh=make_mesh((1,), ("data",)), tenant=d["tenants"][0],
                   tenants=tuple(d["tenants"]), device=ctx.device)
    model = build_model(cfg, device=ctx.device)
    spans = Spans(ctx.device) if ctx.trace else None
    if spans is not None:
        model = spanned_model(model, spans)
    eng = Engine(model, params, cfg, ServeConfig(**mix["engine"]), dp=dp,
                 eos_id=mix["eos_id"])
    return eng, spans


def warm_lengths(mix: dict) -> list[int]:
    """One prompt length for every prefill shape the mix can produce: each
    power-of-two bucket up to the chunk (or the longest prompt), and each
    chunk cover beyond it."""
    w = mix["wave"]["prompt"]
    lo, hi = int(w["min"]), int(w["max"])
    chunk = int(mix["engine"].get("prefill_chunk", 0))
    top = min(hi, chunk) if chunk else hi
    out, b = [], 8
    while b < lo:
        b *= 2
    while True:
        out.append(min(b, hi))
        if b >= top:
            break
        b *= 2
    if chunk and hi > chunk:
        out += list(range(2 * chunk, -(-hi // chunk) * chunk + 1, chunk))
    return sorted(set(out))


def requests(specs: list, rid0: int):
    from repro_torch.serve import Request
    return [Request(rid=rid0 + i, prompt=s["prompt"],
                    max_new_tokens=s["new"], tenant=s["tenant"],
                    out_tokens=Stamps())
            for i, s in enumerate(specs)]


def program(ctx, params) -> dict:
    """Set-up and the window on ``params``: the served requests, the
    end-to-end metrics and the run record, the engine gone after."""
    mix = ctx.cell.mix
    cfg = ctx.cell.model_config()
    eng, spans = build(ctx, params)
    tenants = mix["wave"]["tenants"]
    warm = [{"prompt": np.full(n, int(mix.get("first_id", 0)), np.int32),
             "new": 2, "tenant": tenants[i % len(tenants)]}
            for i, n in enumerate(warm_lengths(mix))]
    eng.run(requests(warm, -len(warm)))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    if spans is not None:
        spans.rows.clear()
    occ0 = sum(s["occupancy_steps"] for s in eng.tenant_stats.values())
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s: warm prompts {warm_lengths(mix)}")

    waves, prof, slice_rows = [], None, (0, 0)
    t0 = time.perf_counter()
    while True:
        i = len(waves)
        reqs = requests(traffic_gen.serve_wave(mix, ctx.seed, i,
                                               cfg.vocab_size),
                        i * 1_000_000)
        t_sub = time.perf_counter()
        if ctx.trace and i == 0:
            r0 = len(spans.rows)
            with Profiled(ctx.device) as prof:
                eng.run(reqs)
            slice_rows = (r0, len(spans.rows))
        else:
            eng.run(reqs)
        t_ret = time.perf_counter()
        waves.append({"submit": t_sub, "requests": reqs})
        if t_ret - t0 >= ctx.seconds:
            break
    window_s = t_ret - t0
    peak = peak_bytes(ctx.device)
    if prof is not None:
        prof.collect()
        log(f"profiled slice: busy {prof.busy_us() / 1e6:.3f} s of "
            f"{prof.window_us() / 1e6:.3f} s; device operations "
            f"{prof.by_op()[:15]}")

    rows = []
    for w in waves:
        for r in w["requests"]:
            rows.append({"prompt": r.prompt, "tokens": list(r.out_tokens),
                         "ttft_ms": stats.ttft_ms(w["submit"], r.t_first)
                         if r.t_first is not None else None,
                         "tpot_ms": stats.tpot_ms(r.out_tokens.at),
                         "ok": r.done and len(r.out_tokens)
                         == r.max_new_tokens})
    served = sum(len(r["tokens"]) for r in rows)
    ttfts = [r["ttft_ms"] for r in rows if r["ttft_ms"] is not None]
    tpots = [r["tpot_ms"] for r in rows if r["tpot_ms"] is not None]
    e2e = {"serve_tok_s": stats.rate(served, window_s),
           "ttft_p95_ms": stats.percentile(ttfts, 95),
           "tpot_p95_ms": stats.percentile(tpots, 95),
           "setup_s": setup_s}
    occupancy = sum(s["occupancy_steps"]
                    for s in eng.tenant_stats.values()) - occ0
    failed = sum(not r["ok"] for r in rows)
    log(f"window {window_s:.2f} s: {len(waves)} waves, {len(rows)} "
        f"requests, {served} tokens, {failed} failed; peak "
        f"{peak / 1e9:.2f} GB")
    del eng
    release(ctx.device)
    return {"e2e": e2e, "rows": rows, "failed": failed, "peak": peak,
            "prof": prof, "record": {
                "m": ctx.cell.config["model"], "mix": mix,
                "window_s": window_s, "rows": rows, "spans": spans,
                "prof": prof, "slice_rows": slice_rows,
                "occupancy_steps": occupancy,
                "max_batch": mix["engine"]["max_batch"]}}


def run(ctx) -> Outcome:
    params = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    p = program(ctx, params)
    out = Outcome(e2e=p["e2e"], record=p["record"], attempted=len(p["rows"]),
                  failed=p["failed"],
                  readings=reference_readings(ctx, params, p["rows"]),
                  memory_peak_bytes=p["peak"])
    if p["prof"] is not None:
        out.busy_s = p["prof"].busy_us() / 1e6
        out.window_s = p["prof"].window_us() / 1e6
        out.breakdown = p["prof"].breakdown()
    return out


def reference_readings(ctx, params, rows, control: bool = False,
                       look: bool = False) -> dict:
    """The plain reference over a sample of the finished requests: each
    prompt with its served tokens, once, and how far each served token's
    logit lies below the reference's best.  With ``control`` the tokens
    judged are the first choices of the reference computed from float8
    products at the same positions (the check's control).  With ``look``
    the five widest gaps come with the nearest routing tie at their
    position (the smallest margin between a token's k-th and next expert
    over the layers) beside the median position's."""
    mix = ctx.cell.mix
    m = ctx.cell.config["model"]
    sample = check.sample_requests([r for r in rows if r["ok"]], ctx.seed,
                                   mix["check"]["sample_tokens"],
                                   mix["check"]["max_requests"])
    ref = REFERENCES[m["family"]]
    gaps, ties = [], []
    t0 = time.perf_counter()
    with float32_exact():
        for r in sample:
            seq = torch.as_tensor(np.concatenate(
                [r["prompt"], np.asarray(r["tokens"][:-1], np.int32)]),
                dtype=torch.long, device=ctx.device)
            pos = torch.arange(len(r["prompt"]) - 1, len(seq),
                               device=ctx.device)
            margins = [] if look else None
            logits = ref(params, m, seq, pos, Precision(), margins=margins)
            if look:
                ties.append(torch.stack(margins).min(0).values[pos].cpu()
                            .numpy())
            tokens = r["tokens"]
            if control:
                tokens = ref(params, m, seq, pos, Precision("fp8")) \
                    .argmax(-1).cpu().numpy()
            gaps.append(check.token_gaps(logits, tokens))
    out = check.gap_readings(np.concatenate(gaps)) if gaps else \
        {"widest_gap": float("inf")}
    if look and gaps:
        g, t = np.concatenate(gaps), np.concatenate(ties)
        worst = np.argsort(-g)[:5]
        out["look"] = {"widest": [[float(g[i]), float(t[i])] for i in worst],
                       "median_tie": float(np.median(t)),
                       "gaps_over_1e-3": int((g > 1e-3).sum())}
    out.update(requests_compared=len(sample),
               reference_s=time.perf_counter() - t0)
    return out


def request_flops(m: dict, rows) -> float:
    return float(sum(flops.serve_request_flops(m, len(r["prompt"]),
                                               len(r["tokens"]))
                     for r in rows))
