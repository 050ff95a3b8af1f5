"""Port parity for the fault-tolerant runtime (``repro_torch.runtime``)
and the training launcher (``repro_torch.launch.train``).

``run_loop`` over the explicit-DP step of the smoke gemma3 (R = 2 ranks)
recovers from injected failures by retrying and, when the retries run
out, by restoring the latest checkpoint, as ``repro``'s does
(mirroring ``tests/test_train_and_ckpt.py``); the loss trajectory of a
run with a hard failure equals ``repro``'s ``run_loop`` over its
explicit step, replayed steps included, at float32 2e-5 relative.  The
launcher on the CPU trains, checkpoints, and a second run resumes from
the checkpoint and gives the first run's last loss exactly (the same
state, bit for bit, after the same steps); with ``--timeline``,
``--elastic`` or a JSONL sink it writes an artifact ``repro`` validates."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import RunConfig as JRun
from repro.configs.base import TrainConfig as JTrain
from repro.core import compat
from repro.core import obs as jobs
from repro.core.dataplane import Dataplane as JDataplane
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.models import build_model as jbuild
from repro.runtime import FaultInjector as JInjector
from repro.runtime import run_loop as jrun_loop
from repro.train import init_state as jinit
from repro.train import make_explicit_dp_step as jmake

from repro_torch.checkpoint import store
from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import CounterTimeline
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM, to_torch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.optim import adamw_init
from repro_torch.runtime import FaultInjector, run_loop
from repro_torch.train import TrainState, make_explicit_dp_step

from torch_port_util import jax_params_np

R = 2
TC = dict(steps=6, learning_rate=5e-3, warmup_steps=2)
DATA = dict(seq_len=16, global_batch=4)


def _port(tp=None):
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = tp if tp is not None else tm.init(0)
    dp = TDataplane(TCfg(mode="cord"), mesh=make_mesh((R,), ("data",)),
                    device="cpu")
    step = make_explicit_dp_step(tm, TRun(train=TTrain(**TC)), dp)
    state = TrainState(params=tp, opt=adamw_init(tp),
                       step=torch.zeros((), dtype=torch.int32))
    loader = ShardedLoader(SyntheticLM(DataConfig(
        vocab_size=tcfg.vocab_size, **DATA)))
    return (lambda s, b: step(s, to_torch(b, "cpu"))), state, loader


def test_loop_recovers_from_injected_failures(tmp_path):
    step, state, loader = _port()
    inj = FaultInjector(fail_steps=(3, 5), max_failures_per_step=1)
    state, rep = run_loop(step, state, loader, steps=8,
                          ckpt_dir=str(tmp_path), checkpoint_every=2,
                          injector=inj, async_ckpt=False)
    assert rep.failures == 2 and rep.restores == 0
    assert rep.steps_run == 8 and int(state.step) == 8
    assert store.latest_step(str(tmp_path)) == 8
    assert len(rep.step_times) == 8 and all(t > 0 for t in rep.step_times)


def test_hard_failure_restores_from_checkpoint(tmp_path):
    step, state, loader = _port()
    # step 5 fails past the retries: back to the step-3 checkpoint, then
    # steps 3 and 4 again, and step 5's fourth try passes
    inj = FaultInjector(fail_steps=(5,), max_failures_per_step=4)
    state, rep = run_loop(step, state, loader, steps=7,
                          ckpt_dir=str(tmp_path), checkpoint_every=3,
                          injector=inj, max_retries=2, async_ckpt=False)
    assert rep.restores == 1 and rep.failures == 4
    assert rep.steps_run == 9 and int(state.step) == 7


def test_trajectory_with_restore_matches_jax(tmp_path):
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jstate = jinit(jm, jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tp = from_jax_params(jax_params_np(jstate.params), tcfg, "cpu")
    mesh = compat.make_mesh((R,), ("data",), devices=jax.devices()[:R])
    jstep = jmake(jm, JRun(train=JTrain(**TC)),
                  JDataplane(JCfg(mode="cord"), mesh=mesh))
    jloader = JLoader(JSynthetic(JDataConfig(vocab_size=jcfg.vocab_size,
                                             **DATA)))
    kw = dict(steps=6, checkpoint_every=3, max_retries=2, async_ckpt=False)
    _, jrep = jrun_loop(
        lambda s, b: jstep(s, {k: jnp.asarray(v) for k, v in b.items()}),
        jstate, jloader, ckpt_dir=str(tmp_path / "jax"),
        injector=JInjector(fail_steps=(5,), max_failures_per_step=3), **kw)
    step, state, loader = _port(tp)
    _, rep = run_loop(step, state, loader, ckpt_dir=str(tmp_path / "port"),
                      injector=FaultInjector(fail_steps=(5,),
                                             max_failures_per_step=3), **kw)
    assert (rep.restores, rep.failures, rep.steps_run) == \
        (jrep.restores, jrep.failures, jrep.steps_run) == (1, 3, 8)
    np.testing.assert_allclose([m["loss"] for m in rep.metrics],
                               [m["loss"] for m in jrep.metrics], rtol=2e-5)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "steps=3", "seq_len=16", "global_batch=2",
            "checkpoint_every=2", f"checkpoint_dir={tmp_path}",
            "log_every=1"]
    s1, rep1 = launch_train.main(argv)
    assert rep1.steps_run == 3 and rep1.restores == 0
    assert store.all_steps(str(tmp_path)) == [2]
    s2, rep2 = launch_train.main(argv)
    assert rep2.restores == 1 and rep2.steps_run == 1
    assert rep2.metrics[0]["loss"] == rep1.metrics[2]["loss"]
    for (path, a), (_, b) in zip(
            tree_flatten({"p": s1.params, "m": s1.opt.mu, "n": s1.opt.nu}),
            tree_flatten({"p": s2.params, "m": s2.opt.mu, "n": s2.opt.nu})):
        assert torch.equal(a, b), path
    out = capsys.readouterr().out
    assert "done: 1 steps, final loss" in out and "all_reduce" in out


@pytest.mark.parametrize("flags", [
    ["--timeline"], ["--elastic", "--ranks", "2"],
    ["--timeline-sink", "sink.jsonl", "--timeline-rotate", "1500"]])
def test_launcher_timeline_flags_run(flags, tmp_path, monkeypatch):
    """``--timeline``, ``--elastic`` and the JSONL sink train on the CPU
    and write a timeline artifact that ``repro``'s validator accepts;
    the sink's segments read back as the artifact's samples."""
    monkeypatch.chdir(tmp_path)
    _, rep = launch_train.main(["--device", "cpu", *flags, "steps=3",
                                "seq_len=16", "global_batch=2"])
    assert rep.steps_run == 3
    with open(tmp_path / "runs" / "torch" / "gemma3-1b_timeline.json") as f:
        doc = json.load(f)
    assert jobs.validate_timeline(doc) is doc
    assert [s["step"] for s in doc["samples"]] == [1, 2, 3]
    assert all(v > 0 for v in doc["rates"]["default"]["ops_s"])
    if "--timeline-sink" in flags:
        back = CounterTimeline.read_rotated(str(tmp_path / "sink.jsonl"))
        assert back.samples == doc["samples"] and back.events == []
        assert (tmp_path / "sink.jsonl.1").exists()


def test_launcher_refuses_model_overrides():
    with pytest.raises(NotImplementedError, match="model"):
        launch_train.main(["--device", "cpu", "model.n_layers=2"])
