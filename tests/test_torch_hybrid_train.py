"""Port parity for training the hybrid family (hymba-1.5b smoke): the
loss and every gradient against ``jax.grad`` of ``repro``'s
``hybrid_loss`` (through the scan's autograd function ``SSMScan`` and
flash's), remat, the plain path, and 3 steps of the explicit-DP and
GSPMD steps against ``repro``'s.  JAX parameters reach the port through
``from_jax_params``; inputs are numpy.

Tolerances: float32 2e-5 (rtol and atol) for losses, gradients,
parameters and moments, as tests/test_kernels.py holds f32; remat against
no remat, records and runtime reports exactly."""

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
from repro.core import compat
from repro.core import policies as jpol
from repro.core.dataplane import Dataplane as JDataplane
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model as jbuild
from repro.train import init_state as jinit
from repro.train import make_explicit_dp_step as jmake_dp
from repro.train import make_train_step as jmake_gspmd

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import policies as tpol
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.data import to_torch
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_explicit_dp_step
from repro_torch.train import make_train_step
from repro_torch.train.step import _value_and_grad

from torch_port_util import jax_params_np, pin_calibration, to_np
from torch_port_util import one_thread  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
pytestmark = pytest.mark.usefixtures("one_thread")
TENANTS = ("train", "alice", "bob")
ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def models():
    jcfg = jget(ARCH, smoke=True)
    jm = jbuild(jcfg)
    jp = jinit(jm, jax.random.PRNGKey(0)).params
    tcfg = tget(ARCH, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _close_tree(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(to_np(t), np.asarray(j),
                                   err_msg=str(path), **tol)


def _batches(cfg, n, seq_len=16, global_batch=4):
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                global_batch=global_batch))
    return [ds.batch_at(i) for i in range(n)]


def _state(tp):
    tp = tree_map(torch.clone, tp)      # the step updates it in place
    return TrainState(params=tp, opt=adamw_init(tp),
                      step=torch.zeros((), dtype=torch.int32))


def test_loss_and_every_gradient_match(models, monkeypatch):
    """``hybrid_loss`` and all gradients, the mamba leaves (``A_log``,
    ``dt_bias``, ``D``) among them, against ``jax.grad``; the scan runs
    as ``SSMScan`` once a layer."""
    jcfg, jm, jp, tcfg, tm, tp = models
    batch = _batches(tcfg, 1, seq_len=24, global_batch=2)[0]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    monkeypatch.setattr(sops.SSMScan, "apply", staticmethod(
        lambda *a, _f=sops.SSMScan.apply: calls.append(1) or _f(*a)))
    (tl, tmet), tg = _value_and_grad(lambda p, b: tm.loss(p, b), tp,
                                     to_torch(batch, "cpu"))
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _close_tree(tg, jg, **TOL)
    for leaf in ("A_log", "dt_bias", "D"):
        assert float(tg["layers"]["mamba"][leaf].abs().min()) > 0, leaf


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none(models, remat):
    _, _, _, tcfg, tm, tp = models
    batch = to_torch(_batches(tcfg, 1, seq_len=8, global_batch=2)[0], "cpu")
    (base, _), bg = _value_and_grad(lambda p, b: tm.loss(p, b), tp, batch)
    (loss, _), g = _value_and_grad(
        lambda p, b: tm.loss(p, b, remat=remat), tp, batch)
    assert torch.equal(loss, base)
    for (path, a), (_, b) in zip(tree_flatten(g), tree_flatten(bg)):
        assert torch.equal(a, b), (remat, path)


def test_plain_impl_is_the_cpu_path(models):
    """On the CPU the kernels' forwards are their plain versions, so
    ``impl="plain"`` gives the same loss and gradients bit for bit."""
    _, _, _, tcfg, tm, tp = models
    batch = to_torch(_batches(tcfg, 1, seq_len=8, global_batch=2)[0], "cpu")
    (base, _), bg = _value_and_grad(lambda p, b: tm.loss(p, b), tp, batch)
    (loss, _), g = _value_and_grad(
        lambda p, b: tm.loss(p, b, impl="plain"), tp, batch)
    assert torch.equal(loss, base)
    for (path, a), (_, b) in zip(tree_flatten(g), tree_flatten(bg)):
        assert torch.equal(a, b), path


def test_explicit_dp_steps_match(models, monkeypatch):
    """3 steps of the explicit data-parallel step on 2 ranks through a
    cord dataplane with a QoS bucket: losses, parameters, moments and the
    runtime report as ``repro``'s."""
    pin_calibration(monkeypatch)
    jcfg, jm, _, tcfg, tm, tp = models
    kw = dict(mode="cord", emulate_costs=True)
    pols = lambda m: [m.TelemetryPolicy(), m.QoSPolicy(  # noqa: E731
        rates={"train": 0.25}, burst=2.0, stall_ns=200.0)]
    jdp = JDataplane(JCfg(**kw), mesh=compat.make_mesh(
        (2,), ("data",), devices=jax.devices()[:2]), tenant="train",
        tenants=TENANTS, policies=pols(jpol))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((2,), ("data",)),
                     tenant="train", tenants=TENANTS, policies=pols(tpol),
                     device="cpu")
    # lr 1e-4 as the GSPMD test's: AdamW's normalised update turns a
    # gradient near eps that differs at f32 rounding into up to lr a step
    tc = dict(steps=3, learning_rate=1e-4, warmup_steps=1)
    jstep = jmake_dp(jm, JRun(train=JTrain(**tc)), jdp,
                     runtime_accounting=True)
    tstep = make_explicit_dp_step(tm, TRun(train=TTrain(**tc)), tdp,
                                  runtime_accounting=True)
    js, ts = jinit(jm, jax.random.PRNGKey(0)), _state(tp)
    jrt, trt = jdp.runtime_init(), tdp.runtime_init()
    for batch in _batches(tcfg, 3):
        js, jmet, jrt = jstep(js, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jrt)
        ts, tmet, trt = tstep(ts, to_torch(batch, "cpu"), trt)
        for k in ("loss", "grad_norm", "acc", "tokens"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _close_tree(ts.params, js.params, **TOL)
    _close_tree(ts.opt.mu, js.opt.mu, **TOL)
    _close_tree(ts.opt.nu, js.opt.nu, **TOL)
    assert tdp.runtime_report(trt) == jdp.runtime_report(jrt)
    assert tdp.runtime_report(trt)["train"]["ops"] == \
        3 * len(tree_flatten(tp))


def test_gspmd_steps_match(models, mesh42, monkeypatch):
    """3 GSPMD steps through a cord dataplane on a 4 x 2 mesh: losses and
    parameters as ``repro``'s, and the step's records one trace of
    ``repro``'s with the layer body (the mamba edges among them) once a
    layer."""
    pin_calibration(monkeypatch)
    jcfg, jm, _, tcfg, tm, tp = models
    rules = {"batch": "data"}
    kw = dict(mode="cord", emulate_costs=True)
    jdp = JDataplane(JCfg(**kw), mesh=mesh42, rules=rules)
    tdp = TDataplane(TCfg(**kw), mesh=make_local_mesh(8, model=2),
                     rules=rules, device="cpu")
    tc = dict(steps=3, learning_rate=1e-4, warmup_steps=1)
    batches = _batches(tcfg, 3, global_batch=8)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    js = jinit(jm, jax.random.PRNGKey(0))
    jstep, jshard = jmake_gspmd(jm, JRun(train=JTrain(**tc)), jdp)
    jstep = jshard(jax.eval_shape(lambda: js), jax.eval_shape(lambda: jb[0]))
    ts = _state(tp)
    tstep, tshard = make_train_step(tm, TRun(train=TTrain(**tc)), tdp)
    tstep = tshard(ts, to_torch(batches[0], "cpu"))
    for i, (b, tb) in enumerate(zip(jb, batches)):
        js, jmet = jstep(js, b)
        if i == 0:
            jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
        n0 = len(tdp.telemetry.records)
        ts, tmet = tstep(ts, to_torch(tb, "cpu"))
        if i == 0:
            trecs = [dataclasses.asdict(r)
                     for r in list(tdp.telemetry.records)[n0:]]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   **TOL)
    _close_tree(ts.params, js.params, **TOL)
    _close_tree(ts.opt.mu, js.opt.mu, **TOL)
    body = [r for r in jrecs if r["tag"].startswith(("attn/", "mamba/",
                                                     "mlp/", "layer/"))]
    assert {"mamba/inner", "mamba/out"} <= {r["tag"] for r in body}
    want = jrecs[:2] + body * tcfg.num_layers + jrecs[2 + len(body):]
    assert trecs == want
