"""The check's control and every fault a cell can have come out as not
correct, at smoke size on the CPU, with the harness's look for a chip
skipped and the rest of a run driven as the benchmark drives it."""

import pytest

from cordbench import check, faults, run, weights
from cordbench.drivers import serve_waves, train_steps
from cordbench.tests import smoke


@pytest.mark.parametrize("workload", ["grok1-serve-burst",
                                      "grok1-prefill-long",
                                      "hymba-serve-chat"])
@pytest.mark.parametrize("fault", faults.SERVE_FAULTS)
def test_serve_fault_is_not_correct(fault, workload):
    ctx = smoke.ctx(workload, seed=31)
    with faults.planted(fault):
        out, ok, rows = run.execute(ctx)
    assert not ok, rows


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_train_fault_is_not_correct(fault):
    ctx = smoke.ctx("hymba-train-dp2", seed=32)
    with faults.planted(fault):
        out, ok, rows = run.execute(ctx)
    assert not ok, rows


@pytest.mark.parametrize("workload", ["grok1-serve-burst",
                                      "grok1-prefill-long",
                                      "hymba-serve-chat"])
def test_serve_control_is_not_correct(workload):
    ctx = smoke.ctx(workload, seed=33)
    params = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    p = serve_waves.program(ctx, params)
    sound = serve_waves.reference_readings(ctx, params, p["rows"])
    ctl = serve_waves.reference_readings(ctx, params, p["rows"],
                                         control=True)
    assert check.judge(sound, ctx.cell.limits)[0]
    assert not check.judge(ctl, ctx.cell.limits)[0], ctl


def test_train_control_is_not_correct():
    ctx = smoke.ctx("hymba-train-dp2", seed=34)
    params = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    p = train_steps.program(ctx, params)
    ref = train_steps.reference(ctx, p["batches"])
    ctl = train_steps.reference(ctx, p["batches"], prec="fp8")
    assert check.judge(check.train_readings(p["prog"], ref),
                       ctx.cell.limits)[0]
    assert not check.judge(check.train_readings(ctl, ref),
                           ctx.cell.limits)[0]


def test_faults_are_put_back():
    from repro_torch.serve import engine
    from repro_torch.train import step
    before = (engine.sample, step.adamw_update, step.rank_grads,
              step.sync_grads)
    for f in faults.SERVE_FAULTS + faults.TRAIN_FAULTS:
        with faults.planted(f):
            pass
    assert (engine.sample, step.adamw_update, step.rank_grads,
            step.sync_grads) == before
