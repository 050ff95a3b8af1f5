"""The port's perftest (``repro_torch.bench.perftest``) on the CPU: its
dry run with the asserts of ``repro``'s (windowed ≡ synchronous flush,
credit starvation stalls, every message completes, churn of ≥ 100 QPs
with retransmissions), and the counters of its tables against
``benchmarks/perftest.py``'s for the same configurations.

Tolerance: exact for every counter (win_hwm, cq_hwm, stalls, credits,
completions, cq_depth; churned QPs, retransmits, timeouts, SRQ grants),
with the delay calibration pinned; times and rates are not compared
(they measure the host, not the card)."""

import json
import math

import pytest

from benchmarks import perftest as jperf

from repro_torch.bench import perftest as tperf

from torch_port_util import pin_calibration

CHURN_KEYS = ("rounds", "qps_per_round", "qps_churned", "bytes",
              "msgs_per_qp", "drop_rate", "corrupt_rate", "bit_identical",
              "retransmits", "timeouts", "srq_grants")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_calibration(monkeypatch)


def test_dry_run_holds_repros_asserts(capsys):
    tperf.dry_run(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "perftest dry-run ok"
    rows = [json.loads(ln) for ln in lines[:-1]]
    assert rows[0] == {"table": "dryrun", "windowed_vs_sync": "bit-identical"}
    tables = {r["table"] for r in rows}
    assert {"window_dryrun", "credits_dryrun", "churn_dryrun"} <= tables
    churn = next(r for r in rows if r["table"] == "churn_dryrun")
    assert churn["qps_churned"] >= 100 and churn["retransmits"] > 0


def test_window_and_credit_counters_match_repro(mesh2):
    kw = dict(sizes=(1024,), windows=(1, 4), n_msgs=8)
    j = jperf.window_sweep(mesh2, **kw)
    t = tperf.window_sweep(tperf.make_mesh2(), device="cpu", **kw)
    ckw = dict(msg_bytes=1024, window=4, n_msgs=8, credit_levels=(2, 8))
    j += jperf.credit_ablation(mesh2, **ckw)
    t += tperf.credit_ablation(tperf.make_mesh2(), device="cpu", **ckw)
    assert len(j) == len(t) == 8
    for a, b in zip(j, t):
        assert {k: a[k] for k in a if k not in ("gbps", "msgs_per_s")} == \
            {k: b[k] for k in b if k not in ("gbps", "msgs_per_s")}
        assert b["gbps"] > 0 and b["msgs_per_s"] > 0


def test_connection_churn_matches_repro(mesh2):
    j = jperf.connection_churn(mesh2, mesh2, emulate=False, msg_bytes=64,
                               rounds=4, qps=4)
    t = tperf.connection_churn(tperf.make_mesh2(), emulate=False,
                               msg_bytes=64, rounds=4, qps=4, device="cpu")
    assert {k: j[0][k] for k in CHURN_KEYS} == \
        {k: t[0][k] for k in CHURN_KEYS}
    assert t[0]["retransmits"] > 0


@pytest.mark.parametrize("op, transport", [("send", "RC"), ("write", "RC"),
                                           ("read", "RC"), ("send", "UD")])
def test_latency_and_throughput_rows_are_finite(op, transport):
    mesh = tperf.make_mesh2()
    dp_b = tperf._dp("bypass", mesh=mesh, device="cpu")
    dp_c = tperf._dp("socket", mesh=mesh, device="cpu", syscall_ns=50.0,
                     interrupt_us=0.2)
    lat = tperf.pingpong_latency_us(mesh, dp_c, dp_b, 256, iters=3,
                                    transport=transport, op=op)
    gbps, rate = tperf.throughput(mesh, dp_c, dp_c, 256, window=4, iters=2,
                                  transport=transport, op=op)
    assert all(math.isfinite(v) and v > 0 for v in (lat, gbps, rate))
    fn, _ = tperf.build_pingpong(mesh, dp_c, dp_b, 16, 2, transport, op)
    import torch
    buf = torch.arange(32, dtype=torch.uint8).reshape(2, 16)
    out = fn(buf)
    # a send / write round trip brings the client's buffer home; a read
    # ends with the server's pulled data synced back to the server
    home = 0 if op != "read" else 1
    want = buf[0] if op != "read" else buf[1]
    assert torch.equal(out[home], want)


def test_fig_tables_run_at_smoke_size(monkeypatch):
    """fig1 / fig3 / fig4 rows and the presets, with short loops."""
    mesh = tperf.make_mesh2()
    preset = tperf.CostPreset("L", syscall_ns=50.0, interrupt_us=0.2,
                              socket_ns=100.0)
    monkeypatch.setattr(tperf, "MSG_SIZES", [64, 4096])
    rows = tperf.fig1(mesh, preset, device="cpu")
    assert [r["variant"] for r in rows[::2]] == [
        "baseline", "no_zero_copy", "no_kernel_bypass", "no_polling"]
    rows = tperf.fig3(mesh, preset, msg_bytes=64, device="cpu")
    assert len(rows) == 16 and all(r["overhead_us"] == 0.0 for r in rows
                                   if (r["client"], r["server"]) ==
                                   ("BP", "BP"))
    rows = tperf.fig4(mesh, preset, sizes=[64], device="cpu")
    assert len(rows) == 4 and all(r["rel_throughput"] > 0 for r in rows)
    presets, l0 = tperf.calibrate_presets(mesh, device="cpu")
    assert l0 > 0 and presets["A"].syscall_ns == 2 * presets["L"].syscall_ns
