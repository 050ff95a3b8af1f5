"""Port parity for the MoE layer (``repro_torch.layers.moe``) against
``repro.layers.moe``: the router, the dropless inference dispatch, the
fixed-capacity training dispatch (with dropped tokens), gated and
ungated experts, gelu and silu, arctic's dense residual, the gradient,
and the dataplane edges.  Parameters are drawn by ``repro`` and handed
over through numpy.

Tolerances: float32 2e-5 (rtol and atol) for gates, aux losses, outputs
and gradients, as tests/test_kernels.py holds f32; expert indices and
the dataplane records (kind, tag, qos, bytes and every other field)
exactly."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import MoEConfig as JMoE
from repro.core import compat
from repro.core.dataplane import Dataplane as JDataplane

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh

from torch_port_util import jax_params_np, pin_calibration, to_np
from torch_port_util import one_thread  # noqa: F401 (fixture)

# the modules (both packages' layers/__init__ export the function ``moe``)
jmoe = importlib.import_module("repro.layers.moe")
tmoe = importlib.import_module("repro_torch.layers.moe")

TOL = dict(rtol=2e-5, atol=2e-5)
pytestmark = pytest.mark.usefixtures("one_thread")
D, F = 16, 32


def _cfgs(**kw):
    base = dict(num_experts=4, top_k=2)
    base.update(kw)
    return JMoE(**base), TMoE(**base)


def _params(jcfg, gated=True, seed=0, d_ff=F):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, d_ff, jcfg, gated=gated)
    return jp, _to_torch(jax_params_np(jp))


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jmoe(cfg, act="silu", group_size=512, train=False):
    """``repro``'s ``moe`` for one configuration, jitted (no dataplane)."""
    return jax.jit(functools.partial(jmoe.moe, cfg=cfg, act=act,
                                     group_size=group_size, train=train))


@functools.lru_cache(maxsize=None)
def _jroute(cfg, train):
    return jax.jit(functools.partial(jmoe.route, cfg=cfg, train=train))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_route_matches(train):
    jcfg, tcfg = _cfgs(num_experts=8)
    jp, tp = _params(jcfg)
    x = _x((40, D))
    jg, ji, ja = _jroute(jcfg, train)(jp, jnp.asarray(x))
    tg, ti, ta = tmoe.route(tp, torch.from_numpy(x), tcfg, train=train)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert tg.dtype == torch.float32 and ta.dtype == torch.float32


@pytest.mark.parametrize("tie", ["pair", "all"])
def test_route_ties_go_to_the_lower_index(tie):
    """Tied router logits: ``jax.lax.top_k`` picks the lower expert index
    first, and so must the port."""
    jcfg, tcfg = _cfgs(num_experts=6)
    router = _x((D, 6), seed=5)
    if tie == "pair":      # experts 1, 3 and 4 always tie
        router[:, 3] = router[:, 1]
        router[:, 4] = router[:, 1]
    else:                  # every logit ties: experts 0 and 1
        router[:] = 0.0
    x = _x((24, D))
    jg, ji, ja = _jroute(jcfg, False)({"router": jnp.asarray(router)},
                                      jnp.asarray(x))
    tg, ti, ta = tmoe.route({"router": torch.from_numpy(router)},
                            torch.from_numpy(x), tcfg, train=False)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    if tie == "all":
        assert (to_np(ti) == [0, 1]).all()
    else:   # some token's pick holds a tied pair, lower index first
        picks = to_np(ti)
        assert ((picks[:, 0] == 1) & (picks[:, 1] == 3)).any()


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"),
                                       (False, "gelu"), (False, "silu")])
@pytest.mark.parametrize("train", [False, True])
def test_moe_matches(gated, act, train):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, gated=gated)
    x = _x((2, 24, D))
    jo, ja = _jmoe(jcfg, act, 16, train)(jp, jnp.asarray(x))
    to, ta = tmoe.moe(tp, torch.from_numpy(x), tcfg, act=act, group_size=16,
                      train=train)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


def test_training_dispatch_drops_tokens():
    """A capacity factor of 0.5 keeps int(16 * 2 * 0.5 / 4) = 4 slots an
    expert a block: tokens are dropped, as ``repro`` drops them."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    assert tmoe._capacity(16, tcfg) == jmoe._capacity(16, jcfg) == 4
    assert tmoe._capacity(1, tcfg) == jmoe._capacity(1, jcfg) == 1
    jp, tp = _params(jcfg)
    x = _x((2, 16, D), seed=7)
    jo, ja = _jmoe(jcfg, "silu", 16, True)(jp, jnp.asarray(x))
    to, ta = tmoe.moe(tp, torch.from_numpy(x), tcfg, group_size=16,
                      train=True)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    # some token lost an expert: its output differs from the dropless one
    eo, _ = tmoe.moe(tp, torch.from_numpy(x), tcfg, group_size=16,
                     train=False)
    rows = (to - eo).abs().amax(-1) > 1e-6
    assert 0 < int(rows.sum()) < rows.numel()


def test_dropless_output_does_not_depend_on_the_batch():
    """Inference is dropless: a row's output is the same alone and among
    others, grouped any way, bit for bit."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x((3, 8, D), seed=2))
    whole, _ = tmoe.moe(tp, x, tcfg, group_size=512)
    for g in (1, 4, 8):
        alone, _ = tmoe.moe(tp, x[1:2], tcfg, group_size=g)
        assert torch.equal(alone, whole[1:2]), g


def test_dense_residual_matches():
    """Arctic: a dense MLP beside the experts, its edges tagged
    ``moe/dense_residual``."""
    jcfg, tcfg = _cfgs(dense_residual=True, dense_residual_ff=24)
    jp, tp = _params(jcfg)
    assert tuple(tp["dense"]["wi"].shape) == (D, 24)
    x = _x((1, 12, D), seed=3)
    for train in (False, True):
        jo, ja = _jmoe(jcfg, train=train)(jp, jnp.asarray(x))
        to, ta = tmoe.moe(tp, torch.from_numpy(x), tcfg, train=train)
        np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
        np.testing.assert_allclose(float(ta), float(ja), **TOL)


def test_init_layout():
    _, tcfg = _cfgs(dense_residual=True, dense_residual_ff=24)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, D, F, tcfg)
    assert {k: tuple(v.shape) for k, v in p.items() if k != "dense"} == {
        "router": (D, 4), "wi": (4, D, F), "wg": (4, D, F), "wo": (4, F, D)}
    assert all(p[k].is_contiguous() for k in ("wi", "wg", "wo"))
    assert "wg" not in tmoe.moe_init(gen, D, F, tcfg, gated=False)


@pytest.mark.parametrize("train", [False, True])
def test_gradient_matches_jax_grad(train):
    """The gradient of sum(out * w) + aux with respect to every parameter
    (the router through the gates and the aux loss) and the input."""
    jcfg, tcfg = _cfgs(dense_residual=True, dense_residual_ff=24)
    jp, tp = _params(jcfg)
    x = _x((2, 16, D), seed=4)
    w = _x((2, 16, D), seed=6)

    def jloss(p, x):
        o, a = jmoe.moe(p, x, jcfg, act="gelu", group_size=8, train=train)
        return jnp.sum(o * jnp.asarray(w)) + a

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    o, a = tmoe.moe(tp, tx, tcfg, act="gelu", group_size=8, train=train)
    (torch.sum(o * torch.from_numpy(w)) + a).backward()
    for t, j in zip(leaves, jax.tree.leaves(jgp)):
        assert t.grad is not None and float(t.grad.abs().max()) > 0
        np.testing.assert_allclose(to_np(t.grad), np.asarray(j), **TOL)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(jgx), **TOL)


def test_dataplane_records_match(monkeypatch):
    """One call through a cord dataplane on a one-card mesh records
    ``repro``'s edges: the six ``moe/*`` edges (dispatch, expert_in and
    out in the ``moe-dispatch`` class) and the dense residual's two, with
    the same bytes, specs and fields; the output is unchanged."""
    pin_calibration(monkeypatch)
    jcfg, tcfg = _cfgs(dense_residual=True, dense_residual_ff=24)
    jp, tp = _params(jcfg)
    x = _x((2, 8, D), seed=8)
    kw = dict(mode="cord", emulate_costs=True)
    jdp = JDataplane(JCfg(**kw), mesh=compat.make_mesh(
        (1,), ("data",), devices=jax.devices()[:1]))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((1,), ("data",)),
                     device="cpu")
    jo, _ = jmoe.moe(jp, jnp.asarray(x), jcfg, dp=jdp)
    to, _ = tmoe.moe(tp, torch.from_numpy(x), tcfg, dp=tdp)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    trecs = [dataclasses.asdict(r) for r in tdp.telemetry.records]
    assert trecs == jrecs
    assert [(r["tag"], r["qos"]) for r in trecs] == [
        ("moe/tokens", "default"), ("moe/dispatch", "moe-dispatch"),
        ("moe/expert_in", "moe-dispatch"), ("moe/hidden", "default"),
        ("moe/expert_out", "default"), ("moe/out", "moe-dispatch"),
        ("moe/dense_residual/hidden", "default"),
        ("moe/dense_residual/out", "default")]
    bare, _ = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(to, bare)


def test_edge_payloads_are_contiguous(monkeypatch):
    """With several groups the expert products come back from einsum as
    permuted views; every edge's payload handed to the dataplane is
    contiguous, as the card's bounce kernel takes it."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((1,), ("data",)), device="cpu")
    seen = []
    real = tdp.constrain

    def spy(x, names, **kw):
        seen.append((kw["tag"], x.is_contiguous()))
        return real(x, names, **kw)

    monkeypatch.setattr(tdp, "constrain", spy)
    tmoe.moe(tp, torch.from_numpy(_x((2, 32, D))), tcfg, group_size=16,
             dp=tdp)
    assert len(seen) == 6 and all(ok for _, ok in seen), seen
