"""Port parity for AdamW, global-norm clipping and the warmup-cosine
schedule (``repro_torch.optim``).

Tolerance: float32 2e-5 (rtol and atol), as tests/test_kernels.py holds
f32: the global norm and the moments are sums taken in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrain
from repro.optim import adamw as jadamw

from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core.tree import tree_flatten
from repro_torch.optim import adamw as tadamw

from torch_port_util import to_np

TOL = dict(rtol=2e-5, atol=2e-5)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": {"tok": scale * rng.standard_normal((16, 8))},
            "layers": {"w": scale * rng.standard_normal((2, 8, 4)),
                       "norm": {"scale": scale * rng.standard_normal((2, 8))}},
            "final": scale * rng.standard_normal((8,))}


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, _np32(tree))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), _np32(tree))


def _close(t_tree, j_tree):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(to_np(t), np.asarray(j), err_msg=str(path),
                                   **TOL)


def test_tree_order_is_jax_order():
    tree = _tree(0)
    assert [p for p, _ in tree_flatten(tree)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("steps,warmup,total", [(10, 3, None), (1, 0, None),
                                                (100, 20, 50)])
def test_schedule_matches(steps, warmup, total):
    jc = JTrain(steps=steps, warmup_steps=warmup, learning_rate=5e-3)
    tc = TTrain(**dataclasses.asdict(jc))
    js, ts = jadamw.warmup_cosine(jc, total), tadamw.warmup_cosine(tc, total)
    for step in range(0, 2 * steps + 3):
        np.testing.assert_allclose(float(ts(torch.tensor(step))),
                                   float(js(step)), **TOL)


@pytest.mark.parametrize("max_norm", [0.0, 0.5, 1e6])
def test_clip_matches(max_norm):
    g = _tree(1, scale=3.0)
    jg, jn = jadamw.clip_by_global_norm(_j(g), max_norm)
    tg, tn = tadamw.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _close(tg, jg)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match(opt_dtype):
    """Five updates from the same parameters and gradients: parameters,
    moments, step and stats stay within tolerance."""
    cfg = dict(learning_rate=1e-2, warmup_steps=2, steps=10, grad_clip=1.0,
               weight_decay=0.1, opt_dtype=opt_dtype)
    jc, tc = JTrain(**cfg), TTrain(**cfg)
    p = _tree(2)
    jp, tp = _j(p), _t(p)
    js, ts = jadamw.adamw_init(jp, opt_dtype), tadamw.adamw_init(tp,
                                                                 opt_dtype)
    for i in range(5):
        g = _tree(10 + i, scale=0.5)
        jp, js, jstats = jadamw.adamw_update(_j(g), js, jp, jc)
        tp, ts, tstats = tadamw.adamw_update(_t(g), ts, tp, tc)
        _close(tp, jp)
        if opt_dtype == "float32":
            _close(ts.mu, js.mu)
            _close(ts.nu, js.nu)
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       **TOL)
    assert all(m.dtype == getattr(torch, opt_dtype)
               for _, m in tree_flatten(ts.mu))
