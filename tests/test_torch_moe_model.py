"""Port parity for the moe family of the transformer on the smoke configs
of grok-1-314b (8 experts cut to 4, top-2, GeGLU, soft cap) and
arctic-480b (128 experts cut to 4, top-2, SwiGLU, a dense residual MLP):
prefill, decode, slot decode and prefill chunks, the loss with its aux
term and every gradient, one explicit-DP step and one GSPMD step.  JAX
parameters from ``repro``'s init reach the port through
``from_jax_params``; inputs are numpy.

Tolerances: float32 2e-5 (rtol and atol) for logits, caches, losses,
gradients and the parameters and moments after one step, as
tests/test_kernels.py holds f32; runtime reports and dataplane records
exactly."""

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
ARCHS = ("grok-1-314b", "arctic-480b")
TENANTS = ("train", "alice", "bob")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = jget(request.param, smoke=True)
    jm = jbuild(jcfg)
    jstate = jinit(jm, jax.random.PRNGKey(0))
    tcfg = tget(request.param, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jstate.params), tcfg, device="cpu")
    return jcfg, jm, jstate.params, tcfg, tm, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_tree(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(to_np(t), np.asarray(j),
                                   err_msg=str(path), **tol)


def _batches(cfg, n, seq_len=16, global_batch=4):
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                global_batch=global_batch))
    return [ds.batch_at(i) for i in range(n)]


def test_params_layout_and_refusal(models):
    jcfg, _, jp, tcfg, tm, tp = models
    e = tcfg.moe.num_experts
    assert tuple(tp["layers"]["moe"]["wi"].shape) == \
        (tcfg.num_layers, e, tcfg.d_model, tcfg.d_ff)
    assert ("dense" in tp["layers"]["moe"]) == tcfg.moe.dense_residual
    # the port's own init has repro's layout
    own = tm.init(0)
    assert [(p, tuple(t.shape)) for p, t in tree_flatten(own)] == \
        [(p, tuple(t.shape)) for p, t in tree_flatten(tp)]
    np_params = jax_params_np(jp)
    del np_params["layers"]["moe"]["wi"]
    with pytest.raises(ValueError, match="no layers/moe/wi"):
        from_jax_params(np_params, tcfg, device="cpu")
    np_params = jax_params_np(jp)
    np_params["layers"]["moe"]["wo"] = np_params["layers"]["moe"]["wo"][:, :1]
    with pytest.raises(ValueError, match="layers/moe/wo"):
        from_jax_params(np_params, tcfg, device="cpu")


def test_prefill_and_decode_match(models):
    jcfg, jm, jp, _, tm, tp = models
    toks = (np.arange(16, dtype=np.int32)[None] * 7 + 3) % jcfg.vocab_size
    toks = np.concatenate([toks, toks[:, ::-1]])          # batch 2
    last = np.array([15, 9], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 20),
                                 last_pos=jnp.asarray(last))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(2, 20),
                        last_pos=_t(last))
    np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for i in range(3):       # gang decode at a shared position
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(16 + i))
        tl, tc = tm.decode_step(tp, _t(tok).long(), tc, 16 + i)
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_decode_slots_match(models):
    jcfg, jm, jp, _, tm, tp = models
    B, S = 3, 24
    rng = np.random.default_rng(1)
    shape = (jcfg.num_layers, B, S, jcfg.attention.num_kv_heads,
             jcfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    tcache = {"k": _t(kc), "v": _t(vc)}
    pos = np.array([2, 9, 15], np.int32)
    tok = np.array([[5], [77], [200]], np.int32)
    step = jax.jit(jm.decode_step_slots)
    for _ in range(3):
        jl, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = tm.decode_step_slots(tp, _t(tok).long(), tcache,
                                          _t(pos))
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tcache[name]), to_np(jcache[name]),
                                   **TOL)


def test_prefill_chunks_match(models):
    """Chunks of 8 at offsets 0-24 against repro's, and their last logits
    against the port's whole prefill."""
    jcfg, jm, jp, _, tm, tp = models
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 32)) \
        .astype(np.int32)
    last = np.asarray([26])
    tt = _t(toks).long()
    tw, _ = tm.prefill(tp, {"tokens": tt}, tm.init_cache(1, 32),
                       last_pos=last)
    tc, jc = tm.init_cache(1, 32), jm.init_cache(1, 32)
    chunk = jax.jit(jm.prefill_chunk)
    for off in range(0, 32, 8):
        tl, tc = tm.prefill_chunk(tp, {"tokens": tt[:, off:off + 8]}, tc,
                                  off, last_pos=last)
        jl, jc = chunk(jp, {"tokens": jnp.asarray(
            toks[:, off:off + 8])}, jc, jnp.int32(off),
            last_pos=jnp.asarray(last, jnp.int32))
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]), **TOL)
    np.testing.assert_allclose(to_np(tl), to_np(tw), **TOL)


def test_loss_aux_and_grads_match(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    batch = _batches(tcfg, 1, seq_len=24, global_batch=2)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, jb)
    (tl, tmet), tg = _value_and_grad(lambda p, b: tm.loss(p, b), tp,
                                     to_torch(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    assert float(tmet["aux"]) > 0
    _close_tree(tg, jg, **TOL)
    router = tg["layers"]["moe"]["router"]
    assert float(router.abs().max()) > 0


def test_explicit_dp_step_matches(models, monkeypatch):
    """One step of the explicit data-parallel step on 2 ranks through a
    cord dataplane with a QoS bucket: loss, parameters, moments and the
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
    tc = dict(steps=1, learning_rate=1e-3, warmup_steps=1)
    jstep = jmake_dp(jm, JRun(train=JTrain(**tc)), jdp,
                     runtime_accounting=True)
    tstep = make_explicit_dp_step(tm, TRun(train=TTrain(**tc)), tdp,
                                  runtime_accounting=True)
    js = jinit(jm, jax.random.PRNGKey(0))
    tp = tree_map(torch.clone, tp)     # the step updates it in place
    ts = TrainState(params=tp, opt=adamw_init(tp),
                    step=torch.zeros((), dtype=torch.int32), err=None)
    batch = _batches(tcfg, 1)[0]
    jrt, trt = jdp.runtime_init(), tdp.runtime_init()
    js, jmet, jrt = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                          jrt)
    ts, tmet, trt = tstep(ts, to_torch(batch, "cpu"), trt)
    for k in ("loss", "grad_norm", "acc", "tokens"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _close_tree(ts.params, js.params, **TOL)
    _close_tree(ts.opt.mu, js.opt.mu, **TOL)
    assert tdp.runtime_report(trt) == jdp.runtime_report(jrt)
    n_leaves = len(tree_flatten(tp))
    assert tdp.runtime_report(trt)["train"]["ops"] == n_leaves


def test_gspmd_step_matches(models, mesh42, monkeypatch):
    """One GSPMD step through a cord dataplane on a 4 x 2 mesh: loss and
    parameters as ``repro``'s, and the step's records one trace of
    ``repro``'s with the layer body (the moe edges among them) once per
    layer."""
    pin_calibration(monkeypatch)
    jcfg, jm, _, tcfg, tm, tp = models
    rules = {"batch": "data"}
    kw = dict(mode="cord", emulate_costs=True)
    jdp = JDataplane(JCfg(**kw), mesh=mesh42, rules=rules)
    tdp = TDataplane(TCfg(**kw), mesh=make_local_mesh(8, model=2),
                     rules=rules, device="cpu")
    tc = dict(steps=1, learning_rate=1e-4, warmup_steps=1)
    batch = _batches(tcfg, 1, global_batch=8)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jinit(jm, jax.random.PRNGKey(0))
    jstep, jshard = jmake_gspmd(jm, JRun(train=JTrain(**tc)), jdp)
    jstep = jshard(jax.eval_shape(lambda: js), jax.eval_shape(lambda: jb))
    tp = tree_map(torch.clone, tp)     # the step updates it in place
    ts = TrainState(params=tp, opt=adamw_init(tp),
                    step=torch.zeros((), dtype=torch.int32))
    tstep, tshard = make_train_step(tm, TRun(train=TTrain(**tc)), tdp)
    tstep = tshard(ts, to_torch(batch, "cpu"))
    js, jmet = jstep(js, jb)
    ts, tmet = tstep(ts, to_torch(batch, "cpu"))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TOL)
    _close_tree(ts.params, js.params, **TOL)
    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    tags = [r["tag"] for r in jrecs]
    trace = jrecs[:tags.index("embed/table", 1)] if \
        tags.count("embed/table") > 1 else jrecs
    body = [r for r in trace if r["tag"].startswith(("attn/", "moe/",
                                                     "layer/"))]
    assert {"moe/dispatch", "moe/hidden", "moe/out"} <= \
        {r["tag"] for r in body}
    want = trace[:2] + body * tcfg.num_layers + trace[2 + len(body):]
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want


def test_remat_carries_the_aux_loss(models):
    """``remat="full"`` and ``"dots"`` checkpoint each layer with its aux
    loss: the loss, its aux term and every gradient as without remat."""
    _, _, _, tcfg, tm, tp = models
    batch = to_torch(_batches(tcfg, 1, seq_len=8, global_batch=2)[0], "cpu")
    (base, bm), bg = _value_and_grad(lambda p, b: tm.loss(p, b), tp, batch)
    for remat in ("full", "dots"):
        (loss, m), g = _value_and_grad(
            lambda p, b: tm.loss(p, b, remat=remat), tp, batch)
        assert torch.equal(loss, base) and torch.equal(m["aux"], bm["aux"])
        for (path, a), (_, b) in zip(tree_flatten(g), tree_flatten(bg)):
            assert torch.equal(a, b), (remat, path)


def test_train_launcher_trains_grok(capsys):
    """``repro_torch.launch.train --arch grok-1-314b`` trains the smoke
    config: every step's loss finite, one all-reduce a leaf a step."""
    from repro_torch.launch import train as launch_train
    state, rep = launch_train.main(["--arch", "grok-1-314b", "--device",
                                    "cpu", "steps=3", "seq_len=16",
                                    "global_batch=2", "log_every=1"])
    assert rep.steps_run == 3
    assert all(np.isfinite(m["loss"]) for m in rep.metrics)
    assert "moe" in state.params["layers"]
    out = capsys.readouterr().out
    assert "done: 3 steps, final loss" in out and "all_reduce" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_forward_and_grads_match_cpu(arch):
    """The smoke model (float32) on the card against the CPU from the same
    parameters: a prefill's logits and the loss with every gradient at
    f32 2e-5; through a cord dataplane on a one-card mesh the card's
    logits and loss are bit for bit those without it, with one bounce
    launch a dataplane record and flash once a layer."""
    from repro_torch.data import DataConfig as TData
    from repro_torch.data import SyntheticLM as TSynth
    from repro_torch.kernels.dataplane import bounce as bk
    from repro_torch.kernels.flash_attention import ops as fa
    from torch_port_util import cuda_device

    dev = cuda_device()
    cfg = tget(arch, smoke=True)
    params = tbuild(cfg, device="cpu").init(0)
    batch = TSynth(TData(vocab_size=cfg.vocab_size, seq_len=24,
                         global_batch=2)).batch_at(0)
    # 96 tokens: two dropless groups of 48, whose expert products come
    # back from einsum as permuted views
    toks = (torch.arange(96)[None] * 7 + 3) % cfg.vocab_size
    out = {}
    for d in ("cpu", dev):
        m = tbuild(cfg, device=d)
        p = {path: t.to(d) for path, t in tree_flatten(params)}
        p = _unflatten(p)
        logits, _ = m.prefill(p, {"tokens": toks.to(d)}, m.init_cache(1, 96))
        (loss, met), g = _value_and_grad(lambda q, b: m.loss(q, b), p,
                                         to_torch(batch, d))
        out[str(d)] = (logits, loss, met["aux"], g)
    (cl, closs, caux, cg), (gl, gloss, gaux, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(gl.cpu(), cl, **TOL)
    torch.testing.assert_close(gloss.cpu(), closs, **TOL)
    torch.testing.assert_close(gaux.cpu(), caux, **TOL)
    for (path, a), (_, b) in zip(tree_flatten(gg), tree_flatten(cg)):
        torch.testing.assert_close(a.cpu(), b, **TOL, msg=str(path))
    # the card through a cord dataplane: the same bits, a bounce a record
    m = tbuild(cfg, device=dev)
    p = _unflatten({path: t.to(dev) for path, t in tree_flatten(params)})
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((1,), ("data",)), device=dev)
    n0, f0 = bk.LAUNCHES, fa.LAUNCHES
    logits, _ = m.prefill(p, {"tokens": toks.to(dev)}, m.init_cache(1, 96),
                          dp=tdp)
    torch.cuda.synchronize()
    ops = sum(v["ops"] for v in tdp.telemetry.by_kind().values())
    assert torch.equal(logits, gl)
    assert bk.LAUNCHES - n0 == ops > 0 and fa.LAUNCHES - f0 == cfg.num_layers
    assert {"moe/dispatch", "moe/hidden", "moe/out"} <= \
        set(tdp.telemetry.by_tag())


def _unflatten(flat: dict) -> dict:
    from repro_torch.core.tree import tree_unflatten
    return tree_unflatten(list(flat), list(flat.values()))
