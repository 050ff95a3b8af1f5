"""Port parity for checkpoints (``repro_torch.checkpoint``): the store's
own round trip and pruning (mirroring ``tests/test_train_and_ckpt.py``),
and the on-disk format shared with ``repro.checkpoint``: a train state
written by either package restores in the other, leaf for leaf, under
the same ``keystr`` paths.

Tolerance: exact (every leaf bit for bit, dtypes kept; bfloat16 leaves
through their uint16 bits)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_model_config as jget
from repro.models import build_model as jbuild
from repro.train import init_state as jinit

from repro_torch.checkpoint import store
from repro_torch.configs import get_model_config as tget
from repro_torch.core.tree import tree_flatten
from repro_torch.models import from_jax_params
from repro_torch.optim import AdamWState
from repro_torch.train import TrainState

from torch_port_util import bits, jax_params_np


def test_checkpoint_roundtrip_and_prune(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "b": {"x": torch.ones(3, dtype=torch.int32),
                  "h": torch.randn(5).to(torch.bfloat16)}}
    for s in (2, 4, 6, 8):
        store.save(str(tmp_path), s, tree, keep_last=2)
    assert store.all_steps(str(tmp_path)) == [6, 8]
    assert store.latest_step(str(tmp_path)) == 8
    like = {"w": torch.zeros(3, 4), "b": {"x": torch.zeros(3),
                                         "h": torch.zeros(5)}}
    back = store.restore(str(tmp_path), 8, like)
    for (path, a), (_, b) in zip(tree_flatten(tree), tree_flatten(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    store.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError):
        store.restore(str(tmp_path), 1, {"w": torch.ones(5)})
    with pytest.raises(ValueError):
        store.restore(str(tmp_path), 1, {"w": torch.ones(4),
                                         "v": torch.ones(1)})


def test_async_save_copies_before_the_thread(tmp_path):
    t = torch.arange(6.0)
    th = store.save(str(tmp_path), 3, {"t": t}, blocking=False)
    t.add_(100.0)        # the caller goes on changing its tensor
    th.join(timeout=60)
    assert not th.is_alive()
    back = store.restore(str(tmp_path), 3, {"t": torch.zeros(6)})
    assert torch.equal(back["t"], torch.arange(6.0))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def states():
    """``repro``'s and the port's train states of the smoke gemma3 with
    distinct values in every leaf (moments and step set)."""
    jcfg = jget("gemma3-1b", smoke=True)
    js = jinit(jbuild(jcfg), jax.random.PRNGKey(0))
    k = iter(range(1, 100))
    js = js._replace(
        opt=js.opt._replace(
            step=jnp.asarray(7, jnp.int32),
            mu=jax.tree.map(lambda p: p * 0.5 + next(k), js.opt.mu),
            nu=jax.tree.map(lambda p: p * 0.25 + next(k), js.opt.nu)),
        step=jnp.asarray(7, jnp.int32))
    tcfg = tget("gemma3-1b", smoke=True)

    def conv(tree):
        return from_jax_params(jax_params_np(tree), tcfg, "cpu")
    ts = TrainState(params=conv(js.params),
                    opt=AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                   mu=conv(js.opt.mu), nu=conv(js.opt.nu)),
                    step=torch.tensor(7, dtype=torch.int32))
    return js, ts


def _same(js, ts):
    jl = jax.tree_util.tree_leaves_with_path(js)
    tl_ = store._flatten(ts)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl_]
    for (path, j), (_, t) in zip(jl, tl_):
        assert str(np.asarray(j).dtype) == str(t.numpy().dtype), path
        np.testing.assert_array_equal(bits(t), bits(np.asarray(j)),
                                      err_msg=jax.tree_util.keystr(path))


def test_jax_checkpoint_restores_in_port(tmp_path, states):
    js, ts = states
    jstore.save(str(tmp_path), 7, js)
    like = TrainState(params=ts.params,
                      opt=AdamWState(step=torch.zeros((), dtype=torch.int32),
                                     mu=ts.params, nu=ts.params),
                      step=torch.zeros((), dtype=torch.int32))
    back = store.restore(str(tmp_path), store.latest_step(str(tmp_path)),
                         like)
    _same(js, back)


def test_port_checkpoint_restores_in_jax(tmp_path, states):
    js, ts = states
    store.save(str(tmp_path), 7, ts)
    man = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert [r["path"] for r in man["leaves"]] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_leaves_with_path(js)]
    like = jax.tree.map(jnp.zeros_like, js)
    back = jstore.restore(str(tmp_path), jstore.latest_step(str(tmp_path)),
                          like)
    _same(back, ts)


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    """A bf16 leaf (``opt_dtype="bfloat16"``): the port writes its uint16
    bits with ``"dtype": "bfloat16"``, which ``repro`` loads as uint16 and
    a caller views as bfloat16; ``repro``'s own bf16 file restores in the
    port as bfloat16."""
    x = np.random.default_rng(0).standard_normal(9).astype(np.float32)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    store.save(str(tmp_path / "t"), 1, {"m": tb})
    man = json.load(open(tmp_path / "t" / "step_00000001" / "manifest.json"))
    assert man["leaves"][0]["dtype"] == "bfloat16"
    got = jstore.restore(str(tmp_path / "t"), 1,
                         {"m": jnp.zeros(9, jnp.bfloat16)})["m"]
    assert np.asarray(got).dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(got), bits(tb).view(np.uint16))
    jb = jnp.asarray(x, jnp.bfloat16)
    jstore.save(str(tmp_path / "j"), 1, {"m": jb})
    back = store.restore(str(tmp_path / "j"), 1, {"m": torch.zeros(9)})["m"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(back), bits(jb))
