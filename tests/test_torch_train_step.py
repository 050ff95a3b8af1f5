"""Port parity for the explicit data-parallel train step on the smoke
gemma3 (``repro_torch.train.step``) against ``repro``'s
``make_explicit_dp_step`` on a 2-device ``("data",)`` mesh, from the
same parameters (``models/convert.py``) and the same synthetic batches.

Tolerances: the loss and every gradient at float32 2e-5 (rtol and atol,
as tests/test_kernels.py holds f32); over the 20-step quickstart
trajectory the losses at 1e-4 relative and the final parameters, moments
at 1e-4 (rtol and atol), since 20 AdamW steps compound f32 differences;
runtime reports (ops, bytes, throttled, kernel_iters...) exactly equal,
with and without int8 compression (whose parameters are held to 2 lr a
step: see the test).

Telemetry repeats by design: ``repro`` records a dataplane op when the
jitted step is *traced*, while the port records each op it runs.  So
one step of the port records exactly one trace of ``repro`` (13 gradient
psums on the smoke gemma3, in issue order), and after n steps the port's
totals are n times one step's, where ``repro``'s stay at its number of
traces (two: it retraces once, when the state's error feedback turns
from None into a tree after the first step)."""

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
from repro.train import make_explicit_dp_step as jmake

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import policies as tpol
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.data import to_torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, make_explicit_dp_step, rank_grads
from repro_torch.train import err_state_init

from torch_port_util import jax_params_np, pin_calibration, to_np

TOL = dict(rtol=2e-5, atol=2e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
TENANTS = ("train", "alice", "bob")
R = 2


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jstate = jinit(jm, jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jstate.params), tcfg, device="cpu")
    return jcfg, jm, jstate, tcfg, tm, tp


def _mesh():
    return compat.make_mesh((R,), ("data",), devices=jax.devices()[:R])


def _dataplanes(qos=True):
    kw = dict(mode="cord", emulate_costs=True)
    pols = lambda m: [m.TelemetryPolicy()] + (  # noqa: E731
        [m.QoSPolicy(rates={"train": 0.25}, burst=2.0, stall_ns=200.0)]
        if qos else [])
    jdp = JDataplane(JCfg(**kw), mesh=_mesh(), tenant="train",
                     tenants=TENANTS, policies=pols(jpol))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((R,), ("data",)),
                     tenant="train", tenants=TENANTS, policies=pols(tpol),
                     device="cpu")
    return jdp, tdp


def _port_state(tp, compression="none"):
    # a copy: the step updates its state in place, and tp is shared
    tp = tree_map(torch.clone, tp)
    return TrainState(params=tp, opt=adamw_init(tp),
                      step=torch.zeros((), dtype=torch.int32),
                      err=err_state_init(tp, compression))


def _batches(cfg, n, seq_len=32, global_batch=4):
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                global_batch=global_batch))
    return [ds.batch_at(i) for i in range(n)]


def _close(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                   err_msg=str(path), **tol)


def test_loss_and_grads_match_value_and_grad(models):
    jcfg, jm, jstate, tcfg, tm, tp = models
    batch = _batches(tcfg, 1, seq_len=24, global_batch=2)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jstate.params, jb)
    losses, metrics, grads = rank_grads(tm, tp, to_torch(batch, "cpu"), 1)
    np.testing.assert_allclose(float(losses[0]), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens"):
        np.testing.assert_allclose(float(metrics[0][k]), float(jmet[k]),
                                   **TOL)
    _close(jax.tree.map(lambda g: to_np(g[0]), grads),
           jax.tree.map(np.asarray, jg), **TOL)


def test_rank_grads_split_the_batch_in_blocks(models):
    """Rank r's gradients are those of the r-th contiguous block alone."""
    _, _, _, tcfg, tm, tp = models
    batch = to_torch(_batches(tcfg, 1, seq_len=16, global_batch=4)[0], "cpu")
    _, _, stacked = rank_grads(tm, tp, batch, 2)
    half = {k: v[2:] for k, v in batch.items()}
    _, _, alone = rank_grads(tm, tp, half, 1)
    for (path, s), (_, a) in zip(tree_flatten(stacked), tree_flatten(alone)):
        assert torch.equal(s[1], a[0]), path


def test_quickstart_trajectory_matches(models, monkeypatch):
    """20 steps of the quickstart run (lr 5e-3, warmup 5; R=2, global
    batch 4, seq_len 32) with runtime accounting through the converged
    dataplane: losses, final state, runtime report, one step's telemetry."""
    pin_calibration(monkeypatch)
    jcfg, jm, jstate, tcfg, tm, tp = models
    tc = dict(steps=20, learning_rate=5e-3, warmup_steps=5)
    jdp, tdp = _dataplanes()
    jstep = jmake(jm, JRun(train=JTrain(**tc)), jdp, runtime_accounting=True)
    tstep = make_explicit_dp_step(tm, TRun(train=TTrain(**tc)), tdp,
                                  runtime_accounting=True)
    # a fresh state: the jitted step donates (deletes) the one it takes
    js, ts = jinit(jm, jax.random.PRNGKey(0)), _port_state(tp)
    jrt, trt = jdp.runtime_init(), tdp.runtime_init()
    jl, tl_ = [], []
    for i, batch in enumerate(_batches(tcfg, 20)):
        js, jmet, jrt = jstep(js, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jrt)
        ts, tmet, trt = tstep(ts, to_torch(batch, "cpu"), trt)
        jl.append(float(jmet["loss"]))
        tl_.append(float(tmet["loss"]))
        if i == 0:
            for k in ("lr", "grad_norm", "acc", "tokens"):
                np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                           **TOL)
            one_step = [(r.kind, r.tag, r.bytes, r.shape, r.dtype, r.qos)
                        for r in tdp.telemetry.records]
    np.testing.assert_allclose(tl_, jl, rtol=1e-4)
    assert tl_[-1] < tl_[0]
    got = train_state_to_numpy(ts)
    want = jax.tree.map(np.asarray, js)
    _close(got["params"], want.params, **TRAJ_TOL)
    _close(got["opt"]["mu"], want.opt.mu, **TRAJ_TOL)
    _close(got["opt"]["nu"], want.opt.nu, **TRAJ_TOL)
    assert int(got["step"]) == int(want.step) == 20
    assert int(got["opt"]["step"]) == int(want.opt.step) == 20
    _close(got["err"], want.err, rtol=0, atol=0)
    # runtime accounting: 13 psums a step, every step
    rep, jrep = tdp.runtime_report(trt), jdp.runtime_report(jrt)
    assert rep == jrep
    assert rep["train"]["ops"] == 13 * 20 and rep["train"]["throttled"] > 0
    # telemetry: one port step = one trace of repro; totals scale by steps
    jrec = [(r.kind, r.tag, r.bytes, r.shape, r.dtype, r.qos)
            for r in jdp.telemetry.records]
    # repro traces its step twice (the state's err goes from None to a
    # tree of zeros after the first step), so it holds two traces
    assert len(one_step) == 13 and jrec == one_step * 2
    assert tdp.telemetry.by_kind()["all_reduce"]["ops"] == 20 * 13
    assert jdp.telemetry.by_kind()["all_reduce"]["ops"] == 2 * 13
    n_params = sum(t.numel() for _, t in tree_flatten(tp))
    assert rep["train"]["bytes"] == 20 * 4 * n_params


def test_int8_step_reports_and_state_match(models, monkeypatch):
    pin_calibration(monkeypatch)
    jcfg, jm, _, tcfg, tm, tp = models
    tc = dict(steps=3, learning_rate=5e-3, warmup_steps=1,
              grad_compression="int8")
    jdp, tdp = _dataplanes()
    jstep = jmake(jm, JRun(train=JTrain(**tc)), jdp, runtime_accounting=True)
    tstep = make_explicit_dp_step(tm, TRun(train=TTrain(**tc)), tdp,
                                  runtime_accounting=True)
    js = jinit(jm, jax.random.PRNGKey(0), compression="int8")
    ts = _port_state(tp, "int8")
    jrt, trt = jdp.runtime_init(), tdp.runtime_init()
    for batch in _batches(tcfg, 3):
        js, jmet, jrt = jstep(js, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jrt)
        ts, tmet, trt = tstep(ts, to_torch(batch, "cpu"), trt)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
    assert tdp.runtime_report(trt) == jdp.runtime_report(jrt)
    # int8 rounding is discontinuous: gradients equal to f32 2e-5 can
    # land on neighbouring int8 levels, and AdamW's normalised update
    # turns such a flip into up to about lr per element and step.  So
    # the parameters are held to 2 lr per step, the residuals' shapes
    # exactly (the payload parity is tests/test_torch_gradsync.py's)
    got = train_state_to_numpy(ts)
    _close(got["params"], jax.tree.map(np.asarray, js.params), rtol=0,
           atol=2 * tc["learning_rate"] * 3)
    assert [np.shape(e) for _, e in tree_flatten(got["err"])] == \
        [np.shape(e) for e in jax.tree.leaves(js.err)]


def test_microbatched_stateless_step_matches(models):
    jcfg, jm, jstate, tcfg, tm, tp = models
    tc = dict(steps=2, learning_rate=5e-3, warmup_steps=1, microbatch=1)
    jdp, tdp = _dataplanes(qos=False)
    jstep = jmake(jm, JRun(train=JTrain(**tc)), jdp)
    tstep = make_explicit_dp_step(tm, TRun(train=TTrain(**tc)), tdp)
    # a fresh state: the jitted step donates (deletes) the one it takes
    js, ts = jinit(jm, jax.random.PRNGKey(0)), _port_state(tp)
    for batch in _batches(tcfg, 2, seq_len=16):
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = tstep(ts, to_torch(batch, "cpu"))
        for k in ("loss", "acc", "tokens", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    # the accumulated gradients themselves, before AdamW (whose update of
    # a gradient near eps is sensitive past f32 2e-5; the trajectory test
    # holds parameters over steps)
    from repro.train.step import _accumulate as jacc
    from repro_torch.train.step import _accumulate as tacc
    batch = _batches(tcfg, 1, seq_len=16)[0]
    (jl, _), jg = jax.jit(lambda p, b: jacc(lambda q, c: jm.loss(q, c), p, b,
                                           1))(
        jax.tree.map(jnp.asarray, jax_params_np(
            jinit(jm, jax.random.PRNGKey(0)).params)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    (tl_, _), tg = tacc(lambda q, c: tm.loss(q, c), tp,
                        to_torch(batch, "cpu"), 1)
    np.testing.assert_allclose(float(tl_), float(jl), **TOL)
    _close(jax.tree.map(to_np, tg), jax.tree.map(np.asarray, jg), **TOL)


def test_other_remat_modes_and_families_wait(models):
    """The ``"full"`` and ``"dots"`` remat modes run (the loss is
    ``"none"``'s, bit for bit; ``tests/test_torch_remat.py`` holds their
    gradients) and an unknown mode raises; training the hybrid family
    is ported: hymba's loss is ``repro``'s at f32 2e-5."""
    _, _, _, tcfg, tm, tp = models
    batch = to_torch(_batches(tcfg, 1, seq_len=8, global_batch=1)[0], "cpu")
    base, _ = tm.loss(tp, batch)
    for remat in ("full", "dots"):
        loss, _ = tm.loss(tp, batch, remat=remat)
        assert torch.equal(loss, base), remat
    with pytest.raises(ValueError, match="remat"):
        tm.loss(tp, batch, remat="everything")
    hcfg = tget("hymba-1.5b", smoke=True)
    jhm = jbuild(jget("hymba-1.5b", smoke=True))
    jhp = jhm.init(jax.random.PRNGKey(0))
    hm = tbuild(hcfg, device="cpu")
    hp = from_jax_params(jax_params_np(jhp), hcfg, device="cpu")
    hb = _batches(hcfg, 1, seq_len=8, global_batch=1)[0]
    jl, _ = jax.jit(jhm.loss)(jhp, {k: jnp.asarray(v) for k, v in hb.items()})
    tl_, _ = hm.loss(hp, to_torch(hb, "cpu"))
    np.testing.assert_allclose(float(tl_), float(jl), **TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_step_matches_cpu(monkeypatch):
    """One explicit-DP step of the smoke gemma3 (float32) on the card and
    on the CPU from the same parameters and batch, through the converged
    dataplane: loss, metrics and the synced gradients at f32 2e-5, runtime
    reports equal (the calibration pinned on both devices), the flash
    kernel with lse launched 4 layers x 2 ranks times, the stall 2 x 13."""
    from repro_torch.core import techniques as ttech
    from repro_torch.data import DataConfig as TData
    from repro_torch.data import SyntheticLM as TSynth
    from repro_torch.kernels.dataplane import stall
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train import sync_grads
    from torch_port_util import PROBE_ITERS, cuda_device

    dev = cuda_device()
    for kind in ("cpu", "cuda"):
        monkeypatch.setitem(ttech._CALIBRATION, (kind, PROBE_ITERS), 1.0)
    cfg = tget("gemma3-1b", smoke=True)
    batch = TSynth(TData(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)).batch_at(0)
    params = tbuild(cfg, device="cpu").init(0)
    out = {}
    for d in ("cpu", dev):
        m = tbuild(cfg, device=d)
        p = _to_device(params, d)
        tdp = TDataplane(TCfg(mode="cord", emulate_costs=True,
                              pallas_dataplane="on"),
                         mesh=make_mesh((R,), ("data",)), tenant="train",
                         tenants=TENANTS,
                         policies=[tpol.TelemetryPolicy(),
                                   tpol.QoSPolicy(rates={"train": 0.25},
                                                  burst=2.0, stall_ns=200.0)],
                         device=d)
        n0 = (fa.LSE_LAUNCHES, stall.LAUNCHES)
        losses, metrics, grads = rank_grads(m, p, to_torch(batch, d), R)
        mean, _, rt = sync_grads(tdp, grads, "data",
                                 state=tdp.runtime_init())
        out[str(d)] = (losses, metrics, mean, tdp.runtime_report(rt),
                       (fa.LSE_LAUNCHES - n0[0], stall.LAUNCHES - n0[1]))
    c, g = out["cpu"], out[str(dev)]
    for a, b in zip(c[0], g[0]):
        torch.testing.assert_close(b.cpu(), a, rtol=2e-5, atol=2e-5)
    for (path, a), (_, b) in zip(tree_flatten(c[2]), tree_flatten(g[2])):
        torch.testing.assert_close(b.cpu(), a, rtol=2e-5, atol=2e-5,
                                   msg=str(path))
    assert g[3] == c[3]
    assert c[4] == (0, 0) and g[4] == (cfg.num_layers * R, 13 * R)


def _to_device(tree, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}
