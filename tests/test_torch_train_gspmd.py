"""Port parity for the GSPMD train step (``train/step.make_train_step``)
on the smoke gemma3 against ``repro``'s, from the same parameters
(``models/convert.py``) and the same synthetic batches: with no mesh
(the step alone) and through a cord dataplane with cost emulation on a
4 x 2 ``("data", "model")`` mesh (``(step, shard_fn)``; every edge of
the loss, the cross entropy's included, crosses the dataplane).  The
first step's gradients are held at 2e-5 too.  The learning rate is
1e-4: AdamW moves a parameter whose gradient is near 0 by up to the
learning rate whatever the gradient's size, so the f32 rounding of such
a gradient (XLA's sharded sums run in another order) shows in the
parameters in proportion to the rate.

Tolerances: the loss, metrics and parameters over 3 steps at float32
2e-5 (rtol and atol); the port with a dataplane against the port
without one bit for bit (mediation changes cost, never results, and the
gradient crosses every edge unchanged); one step's records equal one
trace of ``repro``'s with the layer body once per layer; the
microbatched step against the whole batch as ``repro``'s own test holds
it (loss within 1e-3, parameters at atol 5e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import RunConfig as JRun
from repro.configs.base import TrainConfig as JTrain
from repro.core.dataplane import Dataplane as JDataplane
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model as jbuild
from repro.parallel.sharding import batch_specs as jbatch_specs
from repro.parallel.sharding import param_specs as jparam_specs
from repro.train import init_state as jinit
from repro.train import make_train_step as jmake

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map
from repro_torch.data import to_torch
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import _value_and_grad

from torch_port_util import bits, jax_params_np, pin_calibration

TOL = dict(rtol=2e-5, atol=2e-5)
TC = dict(steps=3, learning_rate=1e-4, warmup_steps=1)
RULES = {"batch": "data"}


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jinit(jm, jax.random.PRNGKey(0))
                                       .params), tcfg, device="cpu")
    return jcfg, jm, tcfg, tm, tp


def _port_state(tp):
    # a copy: the step updates its state in place, and tp is shared
    tp = tree_map(torch.clone, tp)
    return TrainState(params=tp, opt=adamw_init(tp),
                      step=torch.zeros((), dtype=torch.int32))


def _batches(cfg, n, seq_len=16, global_batch=8):
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                global_batch=global_batch))
    return [ds.batch_at(i) for i in range(n)]


def _close(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   err_msg=str(path), **tol)


def _tree(state: TrainState) -> dict:
    return {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu,
            "step": state.step}


def _run_port(tm, tp, step, batches):
    state, losses = _port_state(tp), []
    for b in batches:
        state, m = step(state, to_torch(b, "cpu"))
        losses.append(m["loss"])
    return state, losses


@pytest.mark.parametrize("mesh", [False, True])
def test_gspmd_step_matches_jax(models, mesh42, monkeypatch, mesh):
    pin_calibration(monkeypatch)
    jcfg, jm, tcfg, tm, tp = models
    batches = _batches(tcfg, 3)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    kw = dict(mode="cord", emulate_costs=True)
    jdp = JDataplane(JCfg(**kw), mesh=mesh42 if mesh else None, rules=RULES)
    tdp = TDataplane(TCfg(**kw), mesh=make_local_mesh(8, model=2)
                     if mesh else None, rules=RULES, device="cpu")
    jstep = jmake(jm, JRun(train=JTrain(**TC)), jdp)
    tstep = make_train_step(tm, TRun(train=TTrain(**TC)), tdp)
    js = jinit(jm, jax.random.PRNGKey(0))
    if mesh:
        jstep, jshard = jstep
        tstep, tshard = tstep
        jstep = jshard(jax.eval_shape(lambda: js), jax.eval_shape(
            lambda: jb[0]))
        tstep = tshard(_port_state(tp), to_torch(batches[0], "cpu"))
        st_spec, b_spec = tstep.in_specs
        jps = jparam_specs(js.params, mesh_sizes={"data": 4, "model": 2})
        assert [tuple(s) for s in tree_leaves(st_spec.params)] == \
            [tuple(s) for s in jax.tree.leaves(
                jps, is_leaf=lambda s: isinstance(s, jax.sharding.
                                                  PartitionSpec))]
        assert [tuple(s) for s in tree_leaves(b_spec)] == \
            [tuple(s) for s in jax.tree.leaves(
                jbatch_specs(jb[0], RULES),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
    # the first step's gradients, through the same dataplanes
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, dp=jdp), has_aux=True))(js.params, jb[0])
    (_, _), tg = _value_and_grad(lambda p, b: tm.loss(p, b, dp=tdp), tp,
                                 to_torch(batches[0], "cpu"))
    _close(tg, jg, **TOL)
    jdp.telemetry.reset()
    tdp.telemetry.reset()
    jl = []
    for b in jb:
        js, jm_ = jstep(js, b)
        jl.append(float(jm_["loss"]))
    n0 = len(tdp.telemetry.records)
    ts, tl_ = _run_port(tm, tp, tstep, batches)
    np.testing.assert_allclose([float(x) for x in tl_], jl, **TOL)
    _close(ts.params, js.params, **TOL)
    _close(ts.opt.mu, js.opt.mu, **TOL)
    assert int(ts.step) == int(js.step) == 3
    if not mesh:
        assert not tdp.telemetry.records
        return
    # one port step's records = one trace of repro's (it traces its step
    # more than once), with the layer body once per layer
    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    tags = [r["tag"] for r in jrecs]
    trace = jrecs[:tags.index("embed/table", 1)] if \
        tags.count("embed/table") > 1 else jrecs
    assert jrecs == trace * (len(jrecs) // len(trace))
    body = [r for r in trace if r["tag"].startswith(("attn/", "mlp/",
                                                     "layer/"))]
    want = trace[:2] + body * tcfg.num_layers + trace[2 + len(body):]
    got = [dataclasses.asdict(r) for r in tdp.telemetry.records]
    assert n0 == 0 and got == want * 3
    assert [r["tag"] for r in want[-2:]] == ["loss/table", "loss/logits"]


def test_dataplane_changes_no_bit(models):
    """The port's step through a cord dataplane with cost emulation and
    zero copy removed (socket: bounce copies on every edge) equals the
    step without one, bit for bit, over 2 steps."""
    _, _, tcfg, tm, tp = models
    batches = _batches(tcfg, 2, global_batch=4)
    run = TRun(train=TTrain(**TC))
    outs = []
    for dp in (None, TDataplane(TCfg(mode="socket", emulate_costs=True,
                                     pallas_dataplane="on"),
                                mesh=make_mesh((1,), ("data",)),
                                rules=RULES, device="cpu")):
        step = make_train_step(tm, run, dp if dp is not None else
                               TDataplane(TCfg(), device="cpu"), jit=False)
        outs.append(_run_port(tm, tp, step, batches))
    (s0, l0), (s1, l1) = outs
    assert [float(x) for x in l0] == [float(x) for x in l1]
    for (path, a), (_, b) in zip(tree_flatten(_tree(s0)),
                                 tree_flatten(_tree(s1))):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))


def test_microbatch_matches_whole_batch(models):
    _, _, tcfg, tm, tp = models
    batch = _batches(tcfg, 1, global_batch=8)
    outs = {}
    for mb in (0, 4):
        run = TRun(train=TTrain(microbatch=mb, learning_rate=1e-3))
        step = make_train_step(tm, run, TDataplane(TCfg(), device="cpu"))
        outs[mb] = _run_port(tm, tp, step, batch)
    (s0, l0), (s4, l4) = outs[0], outs[4]
    assert abs(float(l0[0]) - float(l4[0])) < 1e-3
    for (path, a), (_, b) in zip(tree_flatten(s0.params),
                                 tree_flatten(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                   err_msg=str(path))


def test_shard_fn_checks_specs_and_jit_false(models):
    _, _, tcfg, tm, tp = models
    run = TRun(train=TTrain(**TC))
    dp = TDataplane(TCfg(), mesh=make_local_mesh(8, model=2), rules=RULES,
                    device="cpu")
    plain = make_train_step(tm, run, dp, jit=False)
    assert callable(plain)
    _, shard = make_train_step(tm, run, dp)
    odd = to_torch(_batches(tcfg, 1, global_batch=6)[0], "cpu")
    with pytest.raises(ValueError, match="does not split"):
        shard(_port_state(tp), odd)
