"""Port parity for the converged train+serve scenario
(``repro_torch.bench.converged``) against ``benchmarks/converged.py``:
the smoke gemma3 on 8 ranks, the QoS bucket on the train tenant, 2
rounds, from the same two parameter sets (the engine's from seed 0, the
train state's from seed 1, ``repro``'s drawn and converted).

Tolerances: the per-round losses at float32 2e-5 relative (an 8-rank
explicit step, as tests/test_torch_train_step.py holds its losses);
exact: the tokens served to each tenant every round, the requests
completed, ``train_throttled`` and ``train_ops`` (the shared runtime
state), the timeline's ticks and its ``train_step`` events (tick, tenant,
round, throttled).  The port's ``dry_run`` and ``run_all`` run on the
CPU and write under ``runs/torch/``."""

import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import converged as jconv
from repro.configs import get_model_config as jget
from repro.core import obs as jobs
from repro.models import build_model as jbuild

from repro_torch.bench import converged as tconv
from repro_torch.configs import get_model_config as tget
from repro_torch.core import obs as tobs
from repro_torch.core.tree import tree_map
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.train import state_from_params

from torch_port_util import jax_params_np, one_thread  # noqa: F401

LOSS_RTOL = 2e-5
ROUNDS = 2


@pytest.fixture(scope="module")
def port_params():
    """``repro``'s two parameter sets for the smoke gemma3, converted."""
    jm = jbuild(jget(jconv.ARCH, smoke=True))
    cfg = tget(jconv.ARCH, smoke=True)
    return {seed: from_jax_params(
        jax_params_np(jm.init(jax.random.PRNGKey(seed))), cfg,
        device="cpu") for seed in (0, 1)}


@pytest.fixture
def port_from_repro(monkeypatch, port_params):
    """The port's scenario on ``repro``'s parameters: the engine serves
    seed 0's, the train state starts from seed 1's."""
    def build(cfg=None, device=None):
        cfg = tget(jconv.ARCH, smoke=True)
        return cfg, tbuild(cfg, device=device), port_params[0]

    def init_state(model, seed):
        assert seed == 1
        return state_from_params(tree_map(torch.clone, port_params[1]))

    monkeypatch.setattr(tconv, "_build", build)
    monkeypatch.setattr(tconv, "init_state", init_state)


@pytest.fixture(scope="module")
def jax_run():
    timeline = jobs.CounterTimeline(source="bench-converged")
    row = jconv.converged_run(True, rounds=ROUNDS, timeline=timeline)
    return row, timeline


def _events(timeline):
    return [(e["step"], e["tenant"], e["detail"]["round"],
             e["detail"]["throttled"])
            for e in timeline.events if e["kind"] == "train_step"]


def test_converged_round_parity(jax_run, port_from_repro, one_thread):
    jrow, jtl = jax_run
    ttl = tobs.CounterTimeline(source="bench-converged")
    trow = tconv.converged_run(True, rounds=ROUNDS, timeline=ttl,
                               device="cpu")
    np.testing.assert_allclose(
        [r["loss"] for r in trow["rounds_detail"]],
        [r["loss"] for r in jrow["rounds_detail"]], rtol=LOSS_RTOL)
    for key in ("served", "completed", "round"):
        assert [r[key] for r in trow["rounds_detail"]] == \
            [r[key] for r in jrow["rounds_detail"]], key
    for key in ("served_tokens", "train_throttled", "train_ops", "rounds",
                "throttle_train"):
        assert trow[key] == jrow[key], key
    assert trow["train_throttled"] > 0
    assert len(ttl.samples) == len(jtl.samples)
    assert _events(ttl) == _events(jtl)
    for te, je in zip(ttl.events, jtl.events):
        np.testing.assert_allclose(te["detail"]["loss"],
                                   je["detail"]["loss"], rtol=LOSS_RTOL)


def test_dry_run_on_cpu(tmp_path, monkeypatch, one_thread):
    monkeypatch.chdir(tmp_path)
    out = tconv.dry_run(device="cpu")
    doc = json.loads((tmp_path / "runs/torch/converged_timeline.json")
                     .read_text())
    assert len([e for e in doc["events"] if e["kind"] == "train_step"]) == 4
    assert out["row"]["train_throttled"] > 0
    assert len(doc["samples"]) == len(out["doc"]["samples"]) > 0


def test_run_all_ab_rows(tmp_path, monkeypatch, one_thread):
    """The A/B rows, a round each: the bucket off throttles nothing, on it
    throttles the train tenant; both serve every tenant; the artifact
    lands under runs/torch/."""
    monkeypatch.chdir(tmp_path)
    real = tconv.converged_run
    monkeypatch.setattr(tconv, "converged_run",
                        lambda throttle, rounds, **kw: real(throttle, 1,
                                                            **kw))
    rows = tconv.run_all(fast=True, device="cpu")
    assert [r["throttle_train"] for r in rows] == [False, True]
    assert rows[0]["train_throttled"] == 0 < rows[1]["train_throttled"]
    assert rows[0]["train_ops"] == rows[1]["train_ops"] > 0
    for r in rows:
        assert all(v > 0 for v in r["served_tokens"].values())
    doc = json.loads((tmp_path / "runs/torch/BENCH_converged.json")
                     .read_text())
    assert doc["bench"] == "converged" and len(doc["rows"]) == 2
