"""Train steps through the port's explicit data-parallel step and its
dataplane.

Set-up makes the weights from the seed, builds the model, the dataplane
(cord with cost emulation, telemetry, and the QoS bucket on the train
tenant, as the mix states), the step that `make_explicit_dp_step(...,
runtime_accounting=True)` returns and its AdamW state, uploads every
batch the run can use, and drives that same state through the mix's first
steps: they are the steps the plain reference follows.  The window then
runs step after step on new rows and closes with a synchronise after the
step that ends past `--seconds`.  Once the window has closed and the
program's state is gone, the reference runs the first steps again from
the same weights and batches.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from cordbench import cells, check, traffic_gen, weights
from cordbench.common import Outcome, log, peak_bytes, release
from cordbench.reference import train as ref_train
from cordbench.reference.common import Precision, float32_exact
from cordbench.trace import Profiled, Spans

KIND = "train"
PROFILED_STEPS = 2


def build(ctx):
    from repro_torch.configs.base import (DataplaneConfig, RunConfig,
                                          TrainConfig)
    from repro_torch.core import Dataplane, QoSPolicy, TelemetryPolicy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import make_explicit_dp_step
    mix = ctx.cell.mix
    d = mix["dataplane"]
    policies = [TelemetryPolicy()]
    if d.get("qos"):
        policies.append(QoSPolicy(**d["qos"]))
    dp = Dataplane(DataplaneConfig(mode=d["mode"],
                                   emulate_costs=d["emulate_costs"]),
                   mesh=make_mesh((mix["ranks"],), ("data",)),
                   tenant=d["tenants"][0], tenants=tuple(d["tenants"]),
                   policies=policies, device=ctx.device)
    model = build_model(ctx.cell.model_config(), device=ctx.device)
    run = RunConfig(train=TrainConfig(**mix["train"]))
    step = make_explicit_dp_step(model, run, dp, runtime_accounting=True)
    return step, dp


def batches(ctx, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels), each (n, global_batch, seq_len) int32 on the
    device: the rows of steps 0..n-1."""
    mix = ctx.cell.mix
    vocab = ctx.cell.config["model"]["vocab_size"]
    rows = np.stack([traffic_gen.train_batch(mix, ctx.seed, i, vocab)
                     for i in range(n)])
    rows = torch.as_tensor(rows, device=ctx.device)
    return rows[..., :-1].contiguous(), rows[..., 1:].contiguous()


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {"/".join(p): float(t.float().norm()) * scale
            for p, t in weights.leaves(tree)}


def program(ctx, params) -> dict:
    """Set-up, the checked first steps and the window on ``params``
    (updated in place): the program's readings, the end-to-end metrics
    and the run record."""
    from repro_torch.train import state_from_params
    mix = ctx.cell.mix
    m = ctx.cell.config["model"]
    n_check = int(mix["check"]["steps"])
    n_max = n_check + int(math.ceil(ctx.seconds / mix["min_step_s"])) + 2
    tokens, labels = batches(ctx, n_max)
    step, dp = build(ctx)
    state = state_from_params(params)
    rt = dp.runtime_init()

    def feed(i):
        j = i % n_max
        return {"tokens": tokens[j], "labels": labels[j]}

    losses, grad1 = [], None
    for i in range(n_check):
        state, met, rt = step(state, feed(i), rt)
        losses.append(met["loss"])
        if i == 0:
            grad1 = _norms(state.opt.mu, 1.0 / (1.0 - mix["train"]["b1"]))
    start = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    change = {"/".join(p): float((t - s).norm()) for (p, t), (_, s) in
              zip(weights.leaves(state.params), weights.leaves(start))}
    del start
    prog = {"losses": [float(x) for x in losses], "grad1": grad1,
            "change": change}
    release(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s: {n_check} checked steps, losses "
        f"{prog['losses']}")

    spans = Spans(ctx.device) if ctx.trace else None
    prof = None
    i = n_check
    t0 = time.perf_counter()
    while True:
        if spans is None:
            state, _, rt = step(state, feed(i), rt)
            i += 1
        elif prof is None:
            with Profiled(ctx.device) as prof:
                for _ in range(PROFILED_STEPS):
                    state, _, rt = spans.call("step", step, state, feed(i),
                                              rt)
                    i += 1
        else:
            state, _, rt = spans.call("step", step, state, feed(i), rt)
            i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t0
    steps = i - n_check
    peak = peak_bytes(ctx.device)
    if prof is not None:
        prof.collect()
        log(f"profiled slice: busy {prof.busy_us() / 1e6:.3f} s of "
            f"{prof.window_us() / 1e6:.3f} s; device operations "
            f"{prof.by_op()[:15]}")
    tok = mix["global_batch"] * mix["seq_len"]
    log(f"window {window_s:.2f} s: {steps} steps of {tok} tokens; peak "
        f"{peak / 1e9:.2f} GB; throttled "
        f"{dp.runtime_report(rt)['train']['throttled']:.0f}")
    del state, step, dp, rt
    release(ctx.device)
    return {"prog": prog, "peak": peak, "prof": prof, "batches": (tokens,
                                                                   labels),
            "e2e": {"train_tok_s": steps * tok / window_s,
                    "setup_s": setup_s},
            "record": {"m": m, "mix": mix, "window_s": window_s,
                       "steps": steps, "spans": spans, "prof": prof,
                       "profiled_steps": PROFILED_STEPS}}


def reference(ctx, batches_, prec: str = "float32") -> dict:
    """The plain reference's first steps from the seed's weights."""
    mix = ctx.cell.mix
    n = int(mix["check"]["steps"])
    tokens, labels = batches_
    params = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    t0 = time.perf_counter()
    with float32_exact():
        m = ctx.cell.config["model"]
        out = ref_train.train(cells.family(m["family"]).loss, params, m,
                              [(tokens[i], labels[i]) for i in range(n)],
                              mix["train"], Precision(prec),
                              rows=int(mix["check"]["rows"]))
    out["seconds"] = time.perf_counter() - t0
    del params
    release(ctx.device)
    return out


def run(ctx) -> Outcome:
    params = weights.make(ctx.cell.model_config(), ctx.seed, ctx.device)
    p = program(ctx, params)
    del params
    release(ctx.device)
    ref = reference(ctx, p["batches"])
    readings = check.train_readings(p["prog"], ref)
    readings["reference_s"] = ref["seconds"]
    readings["losses"] = p["prog"]["losses"]
    readings["reference_losses"] = ref["losses"]
    out = Outcome(e2e=p["e2e"], record=p["record"],
                  attempted=p["record"]["steps"], failed=0,
                  readings=readings, memory_peak_bytes=p["peak"])
    if p["prof"] is not None:
        out.busy_s = p["prof"].busy_us() / 1e6
        out.window_s = p["prof"].window_us() / 1e6
        out.breakdown = p["prof"].breakdown()
    return out


def step_flops(m: dict, mix: dict) -> float:
    return float(cells.family(m["family"]).train_step_flops(
        m, mix["global_batch"], mix["seq_len"]))
