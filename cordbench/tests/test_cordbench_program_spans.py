"""The program's spans as the benchmark reads them, at smoke size on the
CPU: which per-layer metrics a traced run reports from them, that an
untraced run records none, and the fit that puts them on the
profiler's clock."""

import json

import pytest

from cordbench import cells, program_spans, run
from cordbench.tests import smoke

SERVE, TRAIN = "grok1-serve-burst", "hymba-train-dp2"
HOST = {"queue_wait_p95_ms", "edge_host_us"}
DEVICE = {"moe_cast_ms_per_call", "kv_gather_ms_per_tick",
          "engine_idle_ms_per_tick", "adamw_device_ms",
          "rank_grads_idle_share"}
FIT_US = 50.0


def _traced(workload):
    """A traced smoke run: its result line, its run record, and the
    program spans of its slice with the clock offset."""
    from repro_torch.core import clear_spans
    clear_spans()
    ctx = smoke.ctx(workload, seed=2**31 + 29, trace=True)
    out, ok, rows = run.execute(ctx)
    line = json.loads(json.dumps(run.result(ctx, out, ok, rows)))
    got = program_spans.recorded(out.record)
    clear_spans()
    return line, out.record, got


@pytest.fixture(scope="module")
def traced():
    return {w: _traced(w) for w in (SERVE, TRAIN)}


def test_untraced_run_records_no_program_spans():
    from repro_torch.core import clear_spans, recorded_spans
    clear_spans()
    ctx = smoke.ctx("grok1-prefill-long", seed=2**31 + 31)
    out, ok, rows = run.execute(ctx)
    assert ok and recorded_spans() == []
    assert program_spans.recorded(out.record) is None


def test_traced_run_reports_host_span_metrics_only(traced):
    line, _, _ = traced[SERVE]
    assert line["correct"] is True
    assert HOST <= set(line["metrics"])
    assert not DEVICE & set(line["metrics"])
    for name in HOST:
        assert line["metrics"][name]["value"] > 0
    train_line = traced[TRAIN][0]
    assert not (HOST | DEVICE) & set(train_line["metrics"])


def test_new_readers_find_nothing_without_the_recorder(traced, monkeypatch):
    import repro_torch.core.obs as obs
    record = traced[SERVE][1]
    monkeypatch.delattr(obs, "recorded_spans")
    for name in sorted(HOST | DEVICE):
        assert cells.reader(name)(record) is None
        assert cells.reader(name)({"spans": None, "prof": None}) is None


@pytest.mark.parametrize("workload", (SERVE, TRAIN))
def test_clock_fit_puts_spans_inside_their_harness_span(traced, workload):
    _, record, got = traced[workload]
    spans, off = got
    prof = record["prof"]
    lo, hi = record.get("slice_rows", (0, len(prof.spans)))
    pairs = list(zip(record["spans"].rows[lo:hi], prof.spans))
    held = 0
    for s in spans:
        for row, (_, ps, pe) in pairs:
            if row["start"] * 1e9 <= s.start_ns and \
                    s.end_ns <= row["end"] * 1e9:
                assert ps - FIT_US <= s.start_ns / 1e3 + off
                assert s.end_ns / 1e3 + off <= pe + FIT_US
                held += 1
                break
    assert held > 0
