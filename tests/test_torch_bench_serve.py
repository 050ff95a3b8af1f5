"""Port parity for the serve comparison (``repro_torch.bench.serve``)
against ``benchmarks/serve.py`` on the smoke gemma3, from the same
parameters: ``repro``'s ``_engine`` / ``_serve`` / ``_requests`` on one
side, the port's on the other.

Tolerance: exact — temperature-0 tokens of every engine (gang, fixed
stripe, paged) on the uniform and the mixed stream, the 80-token prompt
prefilled whole and in 16-token chunks, and the tiny pool that preempts;
``decode_compiles``; preemptions and restores; every timeline sample's
step, tenant counters and gauges; the ``ServeError`` of a prompt longer
than any stripe.  The port's ``dry_run`` (its two timing assertions are
``repro``'s: 6 paged slots against 2 stripe slots on 18 requests) and a
one-repeat ``run_all`` run on the CPU."""

import json

import pytest

from benchmarks import serve as jserve
from repro.core import obs as jobs
from repro.serve import ServeError as JServeError

from repro_torch.bench import serve as tserve
from repro_torch.configs import get_model_config as tget
from repro_torch.core import obs as tobs
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import ServeError as TServeError

from torch_port_util import jax_params_np, one_thread  # noqa: F401


@pytest.fixture(scope="module")
def sides():
    """``repro``'s smoke model and parameters, and the port's from them:
    ``(module, cfg, model, params)`` a side."""
    jcfg, jm, jp = jserve._build()
    tcfg = tget("gemma3-1b", smoke=True)
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return {"jax": (jserve, jcfg, jm, jp),
            "port": (tserve, tcfg, tbuild(tcfg, device="cpu"), tp)}


def _tokens(done):
    return {r.rid: list(r.out_tokens) for r in done}


def _samples(timeline):
    return [(s["step"], s["tenants"], s["gauges"])
            for s in timeline.samples]


def _both(sides, fn):
    return {side: fn(*args) for side, args in sides.items()}


STREAMS = {"uniform": dict(n=6, equal_len=8), "mixed": dict(n=8, mixed=True)}


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("engine", ["gang", "fixed", "paged"])
def test_engines_match(sides, engine, stream, one_thread):  # noqa: F811
    kw = dict(STREAMS[stream])
    n = kw.pop("n")
    geom = jserve._PAIR[engine] if stream == "mixed" else \
        {"block_size": jserve.BLOCK} if engine == "paged" else {}

    def run(mod, cfg, model, params):
        tl = (jobs if mod is jserve else tobs).CounterTimeline(source="t")
        eng = mod._engine(cfg, model, params,
                          "gang" if engine == "gang" else "continuous",
                          obs=tl, **geom)
        done, stats = mod._serve(eng, lambda: mod._requests(n, **kw))
        return _tokens(done), stats["decode_compiles"], _samples(tl)

    out = _both(sides, run)
    assert out["port"] == out["jax"]
    assert all(len(t) > 0 for t in out["port"][0].values())


def test_long_prompt(sides, one_thread):  # noqa: F811
    def run(mod, cfg, model, params):
        fixed = mod._engine(cfg, model, params, "continuous")
        err = JServeError if mod is jserve else TServeError
        with pytest.raises(err):
            fixed.run(mod._requests(1, equal_len=80))
        if mod is jserve:
            whole = mod._engine(cfg, model, params, "continuous",
                                block_size=mod.BLOCK)
            chunked = mod._engine(cfg, model, params, "continuous",
                                  block_size=mod.BLOCK, prefill_chunk=16)
            return [list(e.run(mod._requests(1, equal_len=80))[0]
                         .out_tokens) for e in (whole, chunked)]
        lp = mod.long_prompt_runs(cfg, model, params, fixed)
        assert lp["refused"] and lp["chunked_active"]
        return [lp["whole"], lp["chunked"]]

    out = _both(sides, run)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == tserve.MAX_NEW


def test_preemption_and_timeline(sides, tmp_path, monkeypatch,
                                 one_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)

    def run(mod, cfg, model, params):
        if mod is tserve:
            pre = mod.preemption_run(cfg, model, params)
            return pre["tokens"], pre["report"], [
                (s["step"], s["tenants"], s["gauges"])
                for s in pre["doc"]["samples"]]
        tl = jobs.CounterTimeline(source="t")
        tiny = mod._engine(cfg, model, params, "continuous", obs=tl,
                           max_batch=2, kv_cache_len=64,
                           block_size=mod.BLOCK, n_blocks=9)
        done = tiny.run(mod._requests(2, equal_len=8))
        return _tokens(done), tiny.tenant_report()["default"], _samples(tl)

    out = _both(sides, run)
    assert out["port"] == out["jax"]
    rep = out["port"][1]
    assert rep["preemptions"] > 0 and rep["restores"] > 0
    doc = json.loads((tmp_path / "runs/torch/serve_dryrun_timeline.json")
                     .read_text())
    assert "preempt_s" in doc["rate_fields"]


def test_dry_run_on_cpu(tmp_path, monkeypatch, one_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    out = tserve.dry_run(device="cpu")
    assert out["preemptions"] > 0 and out["requests"] == 6
    doc = json.loads((tmp_path / "runs/torch/BENCH_serve.json").read_text())
    assert [r["engine"] for r in doc["rows"]] == ["fixed", "paged"]


def test_run_all_rows(tmp_path, monkeypatch, one_thread):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    rows = tserve.run_all(fast=True, device="cpu", repeats=1)
    assert [(r["engine"], r["queue_depth"]) for r in rows] == \
        [(e, n) for e in ("gang", "fixed", "paged") for n in (8, 16)]
    for r in rows:
        assert r["tok_s"] > 0 and r["ttft_ms_p99"] >= r["ttft_ms_p50"] > 0
        assert (r["decode_compiles"] == 1) == (r["engine"] != "gang")
    for name in ("gang", "fixed", "paged"):
        doc = tobs.CounterTimeline.load(
            str(tmp_path / f"runs/torch/serve_{name}_timeline.json"))
        assert doc["samples"]
    assert (tmp_path / "runs/torch/BENCH_serve.json").exists()
