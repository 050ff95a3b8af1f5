"""The family files (`cordbench/families/`) on pinned inputs give the
weight layouts, model FLOPs and per-layer readings that the benchmark's
single-file layout and FLOPs gave before them (the numbers below were read
from that code); hybrid serving now counts its scans' forward."""

import hashlib
import json

import pytest

from cordbench import cells, flops, weights

LAYOUT = {"grok1-serve-burst": "04ec074238592929",
          "hymba-train-dp2": "90ebbb2fa3324f82"}
REQUESTS = ((32, 16), (256, 128), (512, 77), (900, 100), (1, 1))
SERVE_FLOPS = {
    "grok1-serve-burst": [269489995776, 2195381354496, 3180930170880,
                          5364784693248, 6795018240],
    # without the scans: attention, MLP and mamba projections, logits
    "hymba-train-dp2": [148255590400, 1221058969600, 1874733302400,
                        3224021721600, 3217206400]}
HYMBA_TRAIN_FLOPS = 168713453568000          # 4 x 4096, every window
READINGS = {
    "grok1-serve-burst": {"mfu.serve": 0.02621157730955808,
                          "flash_fwd_roofline": 3.283040473835783},
    "hymba-train-dp2": {"mfu.train": 6.823597717613751,
                        "flash_bwd_roofline": 1725.4383521343022,
                        "flash_fwd_roofline": 13.81865587774314}}


class _Prof:
    kernels = [("k", 0.0, 1.0)]

    def device_us(self, pred):
        return 1234.5 if pred("flash_fwd_x") else 987.25


class _Spans:
    def __init__(self, rows):
        self.rows = rows


def _record(m):
    rows = [{"kind": "prefill", "info": {"tokens": t}}
            for t in (32, 300, 512, 1024)]
    return {"m": m, "prof": _Prof(), "spans": _Spans(rows),
            "slice_rows": (0, 4), "window_s": 42.5, "steps": 17,
            "profiled_steps": 2,
            "rows": [{"prompt": [0] * p, "tokens": [1] * n}
                     for p, n in REQUESTS],
            "mix": {"global_batch": 4, "ranks": 2, "seq_len": 4096}}


@pytest.mark.parametrize("workload", sorted(LAYOUT))
def test_layout_is_the_pinned_one(workload):
    cfg = cells.load(workload).model_config()
    digest = hashlib.sha256(json.dumps(weights.layout(cfg)).encode())
    assert digest.hexdigest()[:16] == LAYOUT[workload]


def test_grok_serving_flops_are_pinned():
    m = cells.load("grok1-serve-burst").config["model"]
    fam = cells.family(m["family"])
    assert [fam.request_flops(m, p, n) for p, n in REQUESTS] == \
        SERVE_FLOPS["grok1-serve-burst"]


def test_hybrid_flops_are_pinned_and_serving_adds_the_scans():
    m = cells.load("hymba-train-dp2").config["model"]
    fam = cells.family(m["family"])
    assert fam.train_step_flops(m, 4, 4096) == HYMBA_TRAIN_FLOPS
    for (p, n), before in zip(REQUESTS, SERVE_FLOPS["hymba-train-dp2"]):
        tokens = p + max(n - 1, 0)
        scans = 32 * 6 * tokens * 3200 * 16      # every layer's scan
        assert fam.request_flops(m, p, n) == before + scans


@pytest.mark.parametrize("workload,metric",
                         [(w, k) for w in READINGS for k in READINGS[w]])
def test_readers_give_the_pinned_readings(workload, metric):
    m = cells.load(workload).config["model"]
    got = cells.reader(metric)(_record(m))
    if metric == "flash_fwd_roofline" and m["family"] == "hybrid":
        # a sum over hymba's 32 windows (none binds at <= 1,024 tokens),
        # where the pinned code multiplied one layer's time by 32
        assert got == pytest.approx(READINGS[workload][metric], rel=1e-12)
    else:
        assert got == READINGS[workload][metric]


def test_hybrid_serving_mfu_counts_the_scans():
    m = cells.load("hymba-train-dp2").config["model"]
    rec = _record(m)
    want = sum(SERVE_FLOPS["hymba-train-dp2"]) + sum(
        32 * 6 * (p + max(n - 1, 0)) * 3200 * 16 for p, n in REQUESTS)
    assert cells.reader("mfu.serve")(rec) == pytest.approx(
        100.0 * want / (42.5 * flops.BF16_FLOPS), rel=1e-12)
