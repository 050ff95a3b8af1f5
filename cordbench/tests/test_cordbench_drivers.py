"""Each driver end to end at smoke size on the CPU, traced and not,
ending in a result line of the contract's shape, judged correct."""

import json
import math

import pytest

from cordbench import run
from cordbench.tests import smoke

CELLS = ("grok1-serve-burst", "hymba-train-dp2", "grok1-prefill-long",
         "hymba-serve-chat")


def _line(workload, trace, seed=2**31 + 11):
    ctx = smoke.ctx(workload, seed=seed, trace=trace)
    out, ok, rows = run.execute(ctx)
    return ctx, out, json.loads(json.dumps(run.result(ctx, out, ok, rows)))


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(workload):
    ctx, out, line = _line(workload, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in ctx.cell.end_to_end}
    assert set(line["metrics"]) == want and "setup_s" in want
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]) and m["value"] > 0, name
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(ctx.cell.limits["compared"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics(workload):
    ctx, out, line = _line(workload, True)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in ctx.cell.per_layer}
    assert set(line["metrics"]) <= names
    # on the CPU no device operation is traced: the device's readers
    # find nothing and are left out, never read as 0
    assert ({"mfu.train"} if "train" in workload else
            {"slot_occupancy", "prefill_ms_mean"}) <= set(line["metrics"])
    for n in ("tick_device_ms", "flash_fwd_roofline", "idle_share.serve",
              "ssm_bwd_roofline", "flash_bwd_roofline",
              "gradsync_device_ms", "idle_share.train"):
        assert n not in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_serve_window_stamps_every_token():
    ctx, out, line = _line(CELLS[0], False, seed=77)
    rows = out.record["rows"]
    assert all(len(r["tokens"]) >= 2 and r["tpot_ms"] > 0 for r in rows)
    assert all(r["ttft_ms"] > 0 for r in rows)
    served = sum(len(r["tokens"]) for r in rows)
    assert line["metrics"]["serve_tok_s"]["value"] == pytest.approx(
        served / out.record["window_s"])


def test_same_seed_same_served_tokens():
    a = _line(CELLS[0], False, seed=123)[1].record["rows"]
    b = _line(CELLS[0], False, seed=123)[1].record["rows"]
    assert [r["tokens"] for r in a] == [r["tokens"] for r in b]


def test_serve_warms_every_prefill_shape():
    from cordbench.drivers.serve_waves import warm_lengths
    mix = smoke.cell(CELLS[0]).mix
    assert warm_lengths(mix) == [8, 16, 32, 64, 96]
    from cordbench import cells
    real = cells.load(CELLS[0]).mix
    assert warm_lengths(real) == [32, 64, 128, 256, 512, 1024, 1536, 2048]
    assert warm_lengths(cells.load(CELLS[2]).mix) == [1024, 2048, 4096]
    assert warm_lengths(smoke.load(CELLS[3]).mix) == [32, 64, 128, 256, 512]
