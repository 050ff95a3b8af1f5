"""Port parity for the hybrid (attention + mamba) family on hymba-1.5b
smoke.

JAX parameters from ``model.init(PRNGKey(0))`` reach the port through
``from_jax_params``; inputs are numpy.  Tolerance: f32 2e-5 (rtol and
atol) on logits, block outputs and all four cache leaves of the 4-layer
smoke model; telemetry totals exact."""

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
from repro.layers.mamba import mamba as jmamba
from repro.layers.mamba import mamba_state_init as jstate_init
from repro.layers.mamba import mamba_state_slot_insert as jslot_insert
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers.mamba import mamba as tmamba
from repro_torch.layers.mamba import mamba_state_init as tstate_init
from repro_torch.layers.mamba import mamba_state_slot_insert as tslot_insert
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.models import hybrid as thybrid

from torch_port_util import jax_params_np, pin_calibration, to_np

TOL = dict(rtol=2e-5, atol=2e-5)
CACHE_LEAVES = ("k", "v", "conv", "h")


@pytest.fixture(scope="module")
def models():
    jcfg = jget("hymba-1.5b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("hymba-1.5b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _assert_cache(tc, jc):
    for name in CACHE_LEAVES:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert to_np(tc[name]).dtype == to_np(jc[name]).dtype, name
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]),
                                   err_msg=name, **TOL)


def test_params_converted_exactly(models):
    _, _, jp, _, tm, tp = models
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init builds the same tree, leaf for leaf in shape
    mine = tm.init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and \
            node.dtype == torch.float32, path


def test_model_flags(models):
    _, _, _, _, tm, _ = models
    assert tm.recurrent is True
    assert tbuild(tget("gemma3-1b", smoke=True), device="cpu").recurrent \
        is False


@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_matches(models, decode):
    """One mamba block from zero state over 7 tokens, and one decode step
    from a given conv tail and h."""
    jcfg, _, jp, tcfg, _, tp = models
    lp_j = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    lp_t = {k: v[1] for k, v in tp["layers"]["mamba"].items()}
    rng = np.random.default_rng(4)
    s = 1 if decode else 7
    di = jcfg.ssm.expand * jcfg.d_model
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    state = None
    if decode:
        state = {"conv": rng.standard_normal(
                     (2, jcfg.ssm.conv_width - 1, di)).astype(np.float32),
                 "h": rng.standard_normal(
                     (2, di, jcfg.ssm.state_size)).astype(np.float32)}
    jo, js = jmamba(lp_j, jnp.asarray(x), jcfg.ssm,
                    state=None if state is None
                    else jax.tree.map(jnp.asarray, state))
    to, ts = tmamba(lp_t, _t(x), tcfg.ssm,
                    state=None if state is None
                    else {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(to_np(to), to_np(jo), **TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(to_np(ts[name]), to_np(js[name]),
                                   err_msg=name, **TOL)
    assert np.abs(to_np(jo)).max() > 0.1


def test_mamba_state_init_and_slot_insert(models):
    """A batch-1 state written whole into slot 2 of a 3-slot state."""
    jcfg, _, _, tcfg, _, _ = models
    js = jstate_init(3, jcfg.d_model, jcfg.ssm, jnp.float32)
    ts = tstate_init(3, tcfg.d_model, tcfg.ssm, torch.float32)
    rng = np.random.default_rng(5)
    one = {k: rng.standard_normal((1,) + tuple(v.shape[1:])).astype(np.float32)
           for k, v in ts.items()}
    js = jslot_insert(js, jax.tree.map(jnp.asarray, one), 2)
    ts = tslot_insert(ts, {k: _t(v) for k, v in one.items()}, 2)
    for name in ("conv", "h"):
        assert tuple(ts[name].shape) == js[name].shape
        np.testing.assert_array_equal(to_np(ts[name]), to_np(js[name]))
        np.testing.assert_array_equal(to_np(ts[name][2:]), one[name])


def test_prefill_logits_and_cache_match(models):
    _, jm, jp, _, tm, tp = models
    toks = (np.arange(13, dtype=np.int32)[None] * 7 + 3) % 256
    toks = np.concatenate([toks, toks[:, ::-1]])          # batch 2
    last = np.array([12, 9], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, 13), last_pos=jnp.asarray(last))
    tl_, tc = tm.prefill(tp, {"tokens": _t(toks).long()},
                         tm.init_cache(2, 13), last_pos=_t(last))
    assert tuple(tl_.shape) == (2, 1, 256) and tl_.dtype == torch.float32
    np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
    _assert_cache(tc, jc)


def test_decode_slots_mixed_positions_match(models):
    """A run of fixed-shape slot decode steps over slots at different
    positions, from a random attention cache and mamba state."""
    jcfg, jm, jp, _, tm, tp = models
    B, S = 3, 24
    rng = np.random.default_rng(1)
    shapes = {name: tuple(v.shape) for name, v in
              tm.init_cache(B, S).items()}
    host = {name: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in shapes.items()}
    jcache = {k: jnp.asarray(v) for k, v in host.items()}
    tcache = {k: _t(v) for k, v in host.items()}
    pos = np.array([2, 9, 15], np.int32)
    tok = np.array([[5], [77], [200]], np.int32)
    step = jax.jit(jm.decode_step_slots)
    for _ in range(4):
        jl, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl_, tcache = tm.decode_step_slots(tp, _t(tok).long(), tcache,
                                           _t(pos))
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache)


def test_gang_decode_step_matches(models):
    _, jm, jp, _, tm, tp = models
    toks = (np.arange(11, dtype=np.int32)[None] * 5 + 1) % 256
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(1, 20))
    tl_, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(1, 20))
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, 11 + i)
        tl_, tc = tm.decode_step(tp, _t(tok).long(), tc, 11 + i)
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    _assert_cache(tc, jc)


def test_cache_updated_in_place(models):
    _, _, _, _, tm, tp = models
    cache = tm.init_cache(1, 6)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = tm.prefill(tp, {"tokens": torch.arange(6)[None]}, cache)
    assert out is cache
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert all(v.abs().sum() > 0 for v in out.values())


def test_training_forward_waits(models):
    """The training forward (``cache=None``), which waited for the
    training slice, is ``repro``'s: its 4-tuple with the final hiddens
    at f32 2e-5, a float32 zero aux, no cache and prefix 0."""
    jcfg, jm, jp, tcfg, _, tp = models
    toks = (np.arange(20, dtype=np.int32).reshape(2, 10) * 7 + 3) % 256
    jx, jaux, jcache, jpre = jax.jit(lambda p, t: jm.apply(
        p, {"tokens": t}, train=True))(jp, jnp.asarray(toks))
    tx, taux, tcache, tpre = thybrid.hybrid_apply(
        tp, tcfg, {"tokens": _t(toks).long()}, train=True)
    np.testing.assert_allclose(to_np(tx), to_np(jx), **TOL)
    assert taux.dtype == torch.float32 and float(taux) == float(jaux) == 0
    assert tcache is None and jcache is None and tpre == jpre == 0


def test_prefill_records_mamba_edges_per_layer(models, monkeypatch):
    """A prefill through a cord dataplane records JAX's edges with the
    layer body (the mamba/* edges included) once per layer."""
    pin_calibration(monkeypatch)
    _, jm, jp, tcfg, tm, tp = models
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True),
                     mesh=compat.make_mesh((8,), ("data",)))
    tokens = np.arange(9, dtype=np.int32)[None]
    jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(1, 9),
               dp=jdp)
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), device="cpu")
    tm.prefill(tp, {"tokens": _t(tokens).long()}, tm.init_cache(1, 9),
               dp=tdp)

    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    body = [r for r in jrecs if r["tag"].startswith(("attn/", "mamba/",
                                                     "mlp/", "layer/"))]
    head, tail = jrecs[:2], jrecs[2 + len(body):]
    assert [r["tag"] for r in head] == ["embed/table", "embed/out"]
    assert [r["tag"] for r in tail] == ["logits/table", "logits/out"]
    assert [r["tag"] for r in body if r["tag"].startswith("mamba/")] == \
        ["mamba/inner", "mamba/out"]
    want = head + body * tcfg.num_layers + tail
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want
    body_tags = {r["tag"] for r in body}
    want_tags = {tag: {k: n * (tcfg.num_layers if tag in body_tags else 1)
                       for k, n in v.items()}
                 for tag, v in jdp.telemetry.by_tag().items()}
    got = tdp.telemetry.by_tag()
    assert got == want_tags
    for tag in ("mamba/inner", "mamba/out"):
        assert got[tag]["ops"] == tcfg.num_layers


@pytest.mark.parametrize("mode", ["prefill", "decode_slots"])
def test_every_edge_payload_is_contiguous(models, mode, monkeypatch):
    """The dataplane kernel on the card takes only contiguous payloads, so
    every edge the hybrid forward issues must be one."""
    _, _, _, tcfg, tm, tp = models
    dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                    mesh=make_mesh((1,), ("data",)), device="cpu")
    seen = []
    inner = TDataplane.constrain

    def constrain(self, x, *a, **k):
        seen.append((k.get("tag"), x.is_contiguous()))
        return inner(self, x, *a, **k)

    monkeypatch.setattr(TDataplane, "constrain", constrain)
    if mode == "prefill":
        tm.prefill(tp, {"tokens": torch.arange(7)[None]}, tm.init_cache(1, 7),
                   dp=dp)
    else:
        tm.decode_step_slots(tp, torch.tensor([[3], [4]]),
                             tm.init_cache(2, 8), torch.tensor([2, 5]), dp=dp)
    assert {"mamba/inner", "mamba/out"} <= {tag for tag, _ in seen}
    assert [tag for tag, ok in seen if not ok] == []

