"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
through the CoRD dataplane, with checkpointing, fault tolerance and int8
gradient compression; the port of ``examples/train_lm.py``.

    python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

``repro`` trains on all local devices (8 host devices on the CPU); here
``make_local_mesh(8)`` stacks 8 ranks on the one device.  Checkpoints go
to ``runs/torch/train_lm`` under the working directory, never to
``repro``'s ``/tmp/repro_train_lm``, and the directory is emptied first,
as ``repro`` empties its own.
"""

from __future__ import annotations

import argparse
import shutil

from repro_torch.configs.base import (
    AttentionConfig, DataplaneConfig, ModelConfig, RunConfig, TrainConfig,
)
from repro_torch.core import Dataplane
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM, to_torch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.runtime import FaultInjector, run_loop
from repro_torch.train import make_explicit_dp_step, state_from_params

# ~100M params: 12L, d_model 512, vocab 50k (llama-style)
CFG_100M = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=512, d_ff=2048,
    vocab_size=50_304,
    attention=AttentionConfig(num_heads=8, num_kv_heads=4),
    max_seq_len=1024, dtype="float32",
)
RANKS = 8
CKPT_DIR = "runs/torch/train_lm"


def run(model, params, *, steps: int = 300, seq_len: int = 256,
        batch: int = 16, mode: str = "cord", injector=None,
        ckpt_dir: str = CKPT_DIR) -> dict:
    """Train ``params`` (updated in place) through ``run_loop`` with the
    example's dataplane, schedule, int8 compression and checkpoints
    every 50 steps in ``ckpt_dir`` (emptied first); returns the run
    report, the final state and the dataplane."""
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {n/1e6:.1f}M params")

    mesh = make_local_mesh(RANKS)
    dp = Dataplane(DataplaneConfig(mode=mode), mesh=mesh, device=model.device)
    train = RunConfig(train=TrainConfig(
        steps=steps, learning_rate=3e-3, warmup_steps=30,
        grad_compression="int8", checkpoint_every=50,
        checkpoint_dir=ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    step = make_explicit_dp_step(model, train, dp, axis="data")
    state = state_from_params(params, compression="int8")
    ds = SyntheticLM(DataConfig(vocab_size=model.cfg.vocab_size,
                                seq_len=seq_len, global_batch=batch))
    loader = ShardedLoader(ds)

    def wrap(s, b):
        return step(s, to_torch(b, model.device))

    state, report = run_loop(
        wrap, state, loader, steps=steps, ckpt_dir=ckpt_dir,
        checkpoint_every=50, injector=injector, log_every=20)

    first = report.metrics[0]["loss"]
    last = report.metrics[-1]["loss"]
    print(f"\nloss: {first:.3f} -> {last:.3f} over {report.steps_run} steps "
          f"({report.failures} failures, {report.restores} restores)")
    print(dp.telemetry.report())
    return {"report": report, "state": state, "dp": dp, "params": n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mode", default="cord")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    model = build_model(CFG_100M, device=args.device)
    injector = FaultInjector(fail_steps=(args.steps // 2,)) \
        if args.inject_failure else None
    return run(model, model.init(0), steps=args.steps, seq_len=args.seq_len,
               batch=args.batch, mode=args.mode, injector=injector)


if __name__ == "__main__":
    main()
