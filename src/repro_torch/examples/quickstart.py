"""Quickstart: build a model, train it through the CoRD dataplane for a
few steps, and inspect what the dataplane saw; the port of
``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart [--device cpu]

``repro`` trains on all local devices (8 host devices on the CPU); here
``make_local_mesh(8)`` stacks 8 ranks on the one device, each rank a
slice of rank-stacked tensors, with the same explicit data-parallel step
(``make_explicit_dp_step``), the same data and the same schedule.  The
telemetry report counts every executed dataplane op, where ``repro``'s
counts each op once per trace of its jitted step: one step here records
what one trace records there.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_model_config
from repro_torch.configs.base import DataplaneConfig, RunConfig, TrainConfig
from repro_torch.core import Dataplane
from repro_torch.data import DataConfig, SyntheticLM, to_torch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.train import make_explicit_dp_step, state_from_params

STEPS = 20
RANKS = 8


def run(model, params, *, steps: int = STEPS) -> dict:
    """Train ``params`` (updated in place) for ``steps`` of the example's
    20-step schedule; returns the losses, the final state and the
    dataplane."""
    cfg = model.cfg
    mesh = make_local_mesh(RANKS)

    # The paper's knob: route every dataplane op through the mediation
    # layer ("cord"), raw kernel-bypass ("bypass"), or the socket path.
    dp = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh,
                   device=model.device)

    train = RunConfig(train=TrainConfig(steps=STEPS, learning_rate=5e-3,
                                        warmup_steps=5))
    step = make_explicit_dp_step(model, train, dp, axis="data")
    state = state_from_params(params)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=16))

    losses = []
    for i in range(steps):
        state, metrics = step(state, to_torch(ds.batch_at(i), model.device))
        losses.append(metrics["loss"])
        if i % 5 == 0:
            print(f"step {i:3d}  loss {float(metrics['loss']):.4f}")

    print("\nWhat the OS saw on the dataplane (telemetry policy):")
    print(dp.telemetry.report())
    return {"losses": [float(v) for v in losses], "state": state, "dp": dp}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = get_model_config("gemma3-1b", smoke=True)
    model = build_model(cfg, device=args.device)
    return run(model, model.init(0))


if __name__ == "__main__":
    main()
