"""Port parity for the ssm family (xlstm-350m smoke: 4 layers of "mmms",
so one unit of three mLSTM blocks and one sLSTM block): the mLSTM and
sLSTM layers, the state slot insert, prefill, decode and slot decode
logits, the loss with every gradient, remat, and a prefill's dataplane
records.  JAX parameters reach the port through ``from_jax_params``;
inputs are numpy.

Tolerances: float32 2e-5 (rtol and atol) for outputs, states, logits,
losses and gradients, as tests/test_kernels.py holds f32; the slot
insert, remat against none and records exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core.dataplane import Dataplane as JDataplane
from repro.layers import xlstm as jx
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten
from repro_torch.data import to_torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers import xlstm as tx
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.train.step import _value_and_grad

from torch_port_util import jax_params_np, pin_calibration, to_np
from torch_port_util import one_thread  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
pytestmark = pytest.mark.usefixtures("one_thread")
ARCH = "xlstm-350m"


@pytest.fixture(scope="module")
def models():
    jcfg = jget(ARCH, smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget(ARCH, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


def _close_tree(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(to_np(t), np.asarray(j),
                                   err_msg=str(path), **tol)


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s,chunk", [(24, 8), (24, 128), (1, 1)])
def test_mlstm_matches(models, s, chunk):
    """The mLSTM block from zero state and again from its own state (the
    carry across chunks and calls), at several chunks, one step of one
    chunk (decode) among them."""
    cfg = models[0].ssm
    d = models[0].d_model
    jp = jx.mlstm_init(jax.random.PRNGKey(1), d, cfg)
    tp = _tree_t(jp)
    x = _x(2, s, d)
    jout, jst = jax.jit(lambda p, x: jx.mlstm(p, x, cfg, chunk=chunk))(
        jp, jnp.asarray(x))
    tout, tst = tx.mlstm(tp, _t(x), cfg, chunk=chunk)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    _close_tree(tst, jst, **TOL)
    jout2, _ = jax.jit(lambda p, x, st: jx.mlstm(p, x, cfg, state=st,
                                                 chunk=chunk))(
        jp, jnp.asarray(x[:, ::-1].copy()), jst)
    tout2, _ = tx.mlstm(tp, _t(x[:, ::-1].copy()), cfg, state=tst,
                        chunk=chunk)
    np.testing.assert_allclose(to_np(tout2), np.asarray(jout2), **TOL)


def test_slstm_matches(models):
    cfg = models[0].ssm
    d = models[0].d_model
    jp = jx.slstm_init(jax.random.PRNGKey(2), d, cfg)
    tp = _tree_t(jp)
    x = _x(2, 11, d, seed=1)
    jout, jst = jax.jit(lambda p, x: jx.slstm(p, x, cfg))(jp, jnp.asarray(x))
    tout, tst = tx.slstm(tp, _t(x), cfg)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    _close_tree(tst, jst, **TOL)


def test_init_layouts_are_repros(models):
    """The port's own init has ``repro``'s tree and shapes, for the
    model and for each block."""
    jcfg, jm, jp, tcfg, tm, tp = models
    own = tm.init(0)
    assert [(p, tuple(t.shape)) for p, t in tree_flatten(own)] == \
        [(p, tuple(t.shape)) for p, t in tree_flatten(tp)]
    gen = torch.Generator().manual_seed(0)
    for ti, ji in ((tx.mlstm_init, jx.mlstm_init),
                   (tx.slstm_init, jx.slstm_init)):
        t = ti(gen, tcfg.d_model, tcfg.ssm)
        j = ji(jax.random.PRNGKey(0), jcfg.d_model, jcfg.ssm)
        assert [tuple(v.shape) for _, v in tree_flatten(t)] == \
            [tuple(v.shape) for v in jax.tree.leaves(j)]
    np_params = jax_params_np(jp)
    del np_params["units"]["blk3"]
    with pytest.raises(ValueError, match="no units/blk3"):
        from_jax_params(np_params, tcfg, device="cpu")


def test_state_slot_insert_matches(models):
    cfg = models[0]
    jst = {**jx.mlstm_state_init(3, cfg.d_model, cfg.ssm)}
    tst = tx.mlstm_state_init(3, cfg.d_model, cfg.ssm)
    rng = np.random.default_rng(4)
    pre = {k: rng.standard_normal((1,) + v.shape[1:]).astype(np.float32)
           for k, v in tst.items()}
    want = jx.xlstm_state_slot_insert(jst, {k: jnp.asarray(v)
                                            for k, v in pre.items()}, 1)
    got = tx.xlstm_state_slot_insert(tst, {k: _t(v) for k, v in pre.items()},
                                     1)
    assert got is tst
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))


def test_prefill_decode_and_slots_match(models):
    jcfg, jm, jp, _, tm, tp = models
    toks = (np.arange(26, dtype=np.int32).reshape(2, 13) * 7 + 3) % 256
    last = np.array([12, 8], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 0),
                                 last_pos=jnp.asarray(last))
    tl_, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(2, 0),
                         last_pos=_t(last))
    np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
    _close_tree(tc, jc, **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    jdec = jax.jit(jm.decode_step_slots)
    for i in range(3):
        pos = np.array([13 + i, 9 + i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl_, tc = tm.decode_step_slots(tp, _t(tok).long(), tc, _t(pos))
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    _close_tree(tc, jc, **TOL)
    jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, 16)
    tl_, tc = tm.decode_step(tp, _t(tok).long(), tc, 16)
    np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)


def test_loss_and_every_gradient_match(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 256, (2, 20)).astype(np.int32),
             "labels": rng.integers(-1, 256, (2, 20)).astype(np.int32)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = to_torch(batch, "cpu")
    (tl_, tmet), tg = _value_and_grad(lambda p, b: tm.loss(p, b), tp, tb)
    np.testing.assert_allclose(float(tl_), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _close_tree(tg, jg, **TOL)
    assert all(float(g.abs().max()) > 0 for _, g in tree_flatten(tg))
    for remat in ("full", "dots"):
        (loss, _), g = _value_and_grad(
            lambda p, b: tm.loss(p, b, remat=remat), tp, tb)
        assert torch.equal(loss, tl_)
        for (path, a), (_, b) in zip(tree_flatten(g), tree_flatten(tg)):
            assert torch.equal(a, b), (remat, path)


def test_prefill_records_match(models, monkeypatch):
    """A prefill through a cord dataplane records ``repro``'s edges, the
    unit body (``mlstm/*``, ``slstm/*`` and one ``layer/out``) once a
    unit."""
    pin_calibration(monkeypatch)
    jcfg, jm, jp, tcfg, tm, tp = models
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True),
                     mesh=compat.make_mesh((8,), ("data",)))
    toks = np.arange(9, dtype=np.int32)[None]
    jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 0),
               dp=jdp)
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), device="cpu")
    tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(1, 0), dp=tdp)
    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    body = [r for r in jrecs if r["tag"].startswith(("mlstm/", "slstm/",
                                                     "layer/"))]
    assert [r["tag"] for r in body] == \
        ["mlstm/inner", "mlstm/out"] * 3 + ["slstm/ffn", "slstm/out",
                                            "layer/out"]
    reps = tcfg.num_layers // len(tcfg.ssm.block_pattern)
    want = jrecs[:2] + body * reps + jrecs[2 + len(body):]
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want
