"""Serve-path benchmark: paged-KV vs fixed-stripe continuous batching,
with the legacy gang scheduler as the convoy baseline (sustained
tokens/s, p50/p99 time-to-first-token, decode-step compile counts); the
port of ``benchmarks/serve.py``.

    python -m repro_torch.bench.serve [--fast] [--dry-run] [--device cpu]

The sweep serves a mixed long+short prompt stream at queue depths well
past ``max_batch`` through three engines — gang, fixed-stripe continuous,
and paged continuous at *equal KV memory* (the paged engine trades the
stripe's per-slot headroom for extra decode slots) — and writes every
row into ``runs/torch/BENCH_serve.json`` next to the per-tick engine
timelines (``runs/torch/serve_*_timeline.json``).  The model is
``repro``'s smoke gemma3 unless the caller passes another config (the
card runs full-width gemma3-1b).  ``decode_compiles`` is the number of
distinct decode-step shapes the engine ran
(:meth:`~repro_torch.serve.Engine.decode_compile_count`), what ``repro``
counts as compiles.

``--dry-run`` is the CI smoke, :func:`dry_run`'s four parts: the paged
engine must emit bit-identical temperature-0 tokens to the fixed stripe
on a uniform stream, admit (and chunk-prefill) a prompt longer than any
stripe, match-or-beat the equal-memory stripe on tok/s with a lower p99
TTFT on the mixed stream, and surface nonzero preemption/restore
counters in the saved timeline artifact.  Each part is a function that
returns what it served, so a caller can hold the same runs to its own
gates.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.configs import get_model_config
from repro_torch.configs.base import ServeConfig
from repro_torch.core.obs import CounterTimeline
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, ServeError

MAX_BATCH = 4
MAX_NEW = 32
KV_LEN = 56
BLOCK = 8
_VARIED_LENGTHS = (5, 9, 14, 7, 15, 6, 11, 13)   # buckets 8 / 16
# Per-request decode budgets: the wide spread is what exposes the gang
# convoy effect — every early finisher idles its slot until the gang's
# longest request (MAX_NEW steps) drains, while continuous refills it.
_VARIED_BUDGETS = (2, MAX_NEW, 3, 5)

# Equal-memory paged-vs-fixed pairing: the stripe engine preallocates
# FIXED_BATCH × PAIR_KV cache positions; the paged engine spends the same
# token capacity as a shared pool (PAIR_BLOCKS × BLOCK positions) and
# runs PAGED_BATCH slots over it — slot count decoupled from stripe size.
FIXED_BATCH = 2
PAGED_BATCH = 6
PAIR_KV = 128
PAIR_BLOCKS = FIXED_BATCH * PAIR_KV // BLOCK
_LONG_EVERY = 6                                   # 1 in 6 requests is long
_LONG_LEN, _LONG_NEW = 40, 24
OUT_DIR = "runs/torch"


def _build(cfg=None, device=None):
    """``cfg`` (``repro``'s smoke gemma3 by default), its model on
    ``device`` and parameters from seed 0."""
    cfg = cfg or get_model_config("gemma3-1b", smoke=True)
    model = build_model(cfg, device=device)
    return cfg, model, model.init(0)


def _requests(n: int, equal_len: int = 0, mixed: bool = False):
    reqs = []
    for i in range(n):
        if mixed and i % _LONG_EVERY == 0:
            ln, new = _LONG_LEN, _LONG_NEW
        else:
            ln = equal_len or _VARIED_LENGTHS[i % len(_VARIED_LENGTHS)]
            new = (MAX_NEW if equal_len else
                   _VARIED_BUDGETS[i % len(_VARIED_BUDGETS)])
        reqs.append(Request(
            rid=i, max_new_tokens=new,
            prompt=np.asarray((np.arange(ln) + 3 * i) % 100, np.int32)))
    return reqs


def _engine(cfg, model, params, scheduler: str, obs=None, *,
            max_batch: int = MAX_BATCH, kv_cache_len: int = KV_LEN,
            block_size: int = 0, n_blocks: int = 0, prefill_chunk: int = 512):
    return Engine(model, params, cfg,
                  ServeConfig(max_batch=max_batch, max_new_tokens=MAX_NEW,
                              kv_cache_len=kv_cache_len, scheduler=scheduler,
                              block_size=block_size, n_blocks=n_blocks,
                              prefill_chunk=prefill_chunk),
                  eos_id=-1, obs=obs)


def _serve(eng, make_reqs, repeats: int = 1):
    """Serve ``make_reqs()`` ``repeats`` times on a warm engine, reporting
    the best wall clock (per-request streams are rebuilt each repeat so
    outputs don't accumulate).  TTFT percentiles come from the best
    repeat — queue wait included, which is exactly what the paged engine's
    extra slots (and chunked prefill) are supposed to shrink.  A request's
    first token is stamped once the host holds it, so on the card every
    time here ends in the device's work."""
    best, done, ttft = float("inf"), [], []
    for _ in range(repeats):
        reqs = make_reqs()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        wall = time.perf_counter() - t0
        if wall < best:
            best, done = wall, out
            ttft = [r.t_first - t0 for r in out if r.t_first is not None]
    toks = sum(len(r.out_tokens) for r in done)
    return done, {
        "tok_s": round(toks / best, 1),
        "ttft_ms_p50": round(1e3 * float(np.percentile(ttft, 50)), 2)
        if ttft else 0.0,
        "ttft_ms_p99": round(1e3 * float(np.percentile(ttft, 99)), 2)
        if ttft else 0.0,
        "decode_compiles": eng.decode_compile_count(),
        "wall_s": round(best, 3),
    }


def _save_artifact(rows: list[dict],
                   path: str = os.path.join(OUT_DIR, "BENCH_serve.json")
                   ) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"bench": "serve", "rows": rows}, f, indent=1)
    return path


_PAIR = {
    "gang": dict(max_batch=FIXED_BATCH, kv_cache_len=PAIR_KV),
    "fixed": dict(max_batch=FIXED_BATCH, kv_cache_len=PAIR_KV),
    "paged": dict(max_batch=PAGED_BATCH, kv_cache_len=PAIR_KV,
                  block_size=BLOCK, n_blocks=PAIR_BLOCKS),
}


def run_all(fast: bool = False, *, cfg=None, device=None,
            repeats: int = 5) -> list[dict]:
    """The sweep: every engine of ``_PAIR`` on the mixed stream at each
    queue depth, best of ``repeats`` (``repro``'s 5)."""
    cfg, model, params = _build(cfg, device)
    depths = (8, 16) if fast else (8, 16, 32)      # queue depth ≫ max_batch
    rows = []
    for name, geom in _PAIR.items():
        scheduler = "gang" if name == "gang" else "continuous"
        # per-tick engine timeline, written next to the bench JSON
        timeline = CounterTimeline(source=f"bench-serve/{name}")
        eng = _engine(cfg, model, params, scheduler, obs=timeline, **geom)
        eng.run(_requests(8, mixed=True))          # warm the caches
        for n in depths:
            _, stats = _serve(eng, lambda n=n: _requests(n, mixed=True),
                              repeats=repeats)
            row = {"table": "serve", "engine": name,
                   "queue_depth": n, "max_new_tokens": MAX_NEW,
                   **geom, **stats}
            rows.append(row)
            print(json.dumps(row))
        path = timeline.save(os.path.join(OUT_DIR,
                                          f"serve_{name}_timeline.json"))
        print(json.dumps({"table": "serve", "engine": name,
                          "timeline": path,
                          "ticks": len(timeline.samples)}))
    print(json.dumps({"table": "serve",
                      "artifact": _save_artifact(rows)}))
    return rows


# ---------------------------------------------------------------------------
# the dry run's four parts
# ---------------------------------------------------------------------------

def uniform_runs(cfg, model, params) -> dict:
    """Part 1: 6 requests of 8 tokens, ``MAX_NEW`` new each, on the
    gang, fixed-stripe and paged engines (the same batch geometry for
    all three); each engine's tokens by request id and the continuous
    engines' stats.  The fixed engine is returned for part 2."""
    make = lambda: _requests(6, equal_len=8)  # noqa: E731
    done_g, stats_g = _serve(_engine(cfg, model, params, "gang"), make)
    fixed = _engine(cfg, model, params, "continuous")
    done_f, stats_f = _serve(fixed, make)
    paged = _engine(cfg, model, params, "continuous", block_size=BLOCK)
    done_p, stats_p = _serve(paged, make)
    return {"tokens": {name: {r.rid: list(r.out_tokens) for r in done}
                       for name, done in (("gang", done_g),
                                          ("fixed", done_f),
                                          ("paged", done_p))},
            "stats": {"gang": stats_g, "fixed": stats_f, "paged": stats_p},
            "paged_active": paged.paged, "fixed_engine": fixed}


def long_prompt_runs(cfg, model, params, fixed) -> dict:
    """Part 2: an 80-token prompt, longer than any stripe, on ``fixed``
    (refused at submit with :class:`ServeError`) and on the paged engine
    prefilled whole and in 16-token chunks."""
    long_req = lambda: _requests(1, equal_len=80)  # noqa: E731
    try:
        fixed.run(long_req())
        refused = None
    except ServeError as e:
        refused = str(e)
    whole = _engine(cfg, model, params, "continuous", block_size=BLOCK)
    (done_w,) = whole.run(long_req())
    chunked = _engine(cfg, model, params, "continuous", block_size=BLOCK,
                      prefill_chunk=16)
    (done_c,) = chunked.run(long_req())
    return {"refused": refused, "chunked_active": chunked.chunked,
            "whole": list(done_w.out_tokens),
            "chunked": list(done_c.out_tokens)}


def equal_memory_pair(cfg, model, params, repeats: int = 3) -> dict:
    """Part 3: the fixed stripe and the paged pool at equal KV memory on
    18 requests of the mixed stream, each warmed first, best of
    ``repeats``; stats by engine."""
    pair = {}
    for name in ("fixed", "paged"):
        eng = _engine(cfg, model, params, "continuous", **_PAIR[name])
        eng.run(_requests(8, mixed=True))          # warm the caches
        _, pair[name] = _serve(eng, lambda: _requests(18, mixed=True),
                               repeats=repeats)
    return pair


def preemption_run(cfg, model, params) -> dict:
    """Part 4: two co-resident requests on a 9-block pool — enough for
    one request's whole lifetime (the submit bound), not for both
    residents' decode growth (5 blocks each by the end) — so the engine
    preempts and restores; the timeline is saved and loaded back."""
    timeline = CounterTimeline(source="bench-serve/dryrun")
    tiny = _engine(cfg, model, params, "continuous", obs=timeline,
                   max_batch=2, kv_cache_len=64, block_size=BLOCK,
                   n_blocks=9)
    done = tiny.run(_requests(2, equal_len=8))
    path = timeline.save(os.path.join(OUT_DIR, "serve_dryrun_timeline.json"))
    return {"tokens": {r.rid: list(r.out_tokens) for r in done},
            "report": tiny.tenant_report()["default"],
            "doc": CounterTimeline.load(path), "timeline": path}


def dry_run(*, cfg=None, device=None) -> dict:
    """CI smoke for the paged serving engine (see module docstring)."""
    cfg, model, params = _build(cfg, device)

    # 1. uniform stream: gang ≡ fixed stripe ≡ paged at temperature 0,
    #    one decode compile on both continuous layouts
    uni = uniform_runs(cfg, model, params)
    toks, stats = uni["tokens"], uni["stats"]
    if not uni["paged_active"]:
        raise AssertionError("paged layout did not activate")
    if toks["fixed"] != toks["gang"]:
        raise AssertionError("continuous != gang at temperature 0")
    if toks["paged"] != toks["fixed"]:
        raise AssertionError("paged != fixed stripe at temperature 0")
    for name in ("fixed", "paged"):
        if stats[name]["decode_compiles"] != 1:
            raise AssertionError(f"{name}: {stats[name]}")

    # 2. a prompt longer than ANY fixed stripe: the stripe engine rejects
    #    it at submit; the paged engine serves it (chunk-at-a-time
    #    prefill, 80 tokens through 16-token chunks), and chunked prefill
    #    changes no tokens vs whole-prompt paged prefill
    lp = long_prompt_runs(cfg, model, params, uni["fixed_engine"])
    if lp["refused"] is None:
        raise AssertionError("stripe engine admitted an 80-token prompt "
                             f"into kv_cache_len={KV_LEN}")
    if not lp["chunked_active"]:
        raise AssertionError("chunked prefill did not activate")
    if len(lp["whole"]) != MAX_NEW:
        raise AssertionError(f"whole prefill served {len(lp['whole'])} "
                             f"tokens, want {MAX_NEW}")
    if lp["chunked"] != lp["whole"]:
        raise AssertionError("chunked prefill != whole prefill at "
                             "temperature 0")

    # 3. equal-memory mixed sweep: paged (more slots, same KV tokens)
    #    must match-or-beat the fixed stripe on sustained tok/s and p99
    #    TTFT at a queue depth well past either batch
    pair = equal_memory_pair(cfg, model, params)
    rows = [{"table": "serve_dryrun", "engine": name, "queue_depth": 18,
             **_PAIR[name], **pair[name]} for name in ("fixed", "paged")]
    if not (pair["paged"]["tok_s"] >= pair["fixed"]["tok_s"]
            and pair["paged"]["ttft_ms_p99"] <= pair["fixed"]["ttft_ms_p99"]):
        raise AssertionError(f"paged lost to the equal-memory stripe: "
                             f"{pair}")

    # 4. preemption visibility: a pool too small for both residents
    #    forces preempt→resume, and the counters land in the timeline
    #    artifact (cumulative counters + preempt_s/restore_s rates)
    pre = preemption_run(cfg, model, params)
    rep, doc = pre["report"], pre["doc"]
    if not all(len(t) == MAX_NEW for t in pre["tokens"].values()):
        raise AssertionError(f"a preempted request lost tokens: "
                             f"{pre['tokens']}")
    if not (rep["preemptions"] > 0 and rep["restores"] > 0):
        raise AssertionError(f"the tiny pool never preempted: {rep}")
    if not doc["samples"]:
        raise AssertionError("engine timeline captured no ticks")
    last = doc["samples"][-1]["tenants"]["default"]
    if not (last["preemptions"] > 0 and last["restores"] > 0):
        raise AssertionError(f"the timeline misses the preemptions: {last}")
    if not ("preempt_s" in doc["rate_fields"]
            and "restore_s" in doc["rate_fields"]):
        raise AssertionError(f"rate fields {doc['rate_fields']}")
    if "free_blocks" not in doc["samples"][-1]["gauges"]:
        raise AssertionError("no free_blocks gauge in the timeline")

    summary = {"table": "serve_dryrun", "requests": len(toks["paged"]),
               "timeline": pre["timeline"], "ticks": len(doc["samples"]),
               "preemptions": rep["preemptions"],
               "restores": rep["restores"],
               "fixed": pair["fixed"], "paged": pair["paged"],
               "artifact": _save_artifact(rows)}
    print(json.dumps(summary))
    print("serve dry-run ok")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="the CI smoke: the dry run's four parts")
    ap.add_argument("--fast", action="store_true",
                    help="queue depths 8 and 16 instead of 8, 16 and 32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.dry_run:
        dry_run(device=args.device)
    else:
        run_all(fast=args.fast, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
