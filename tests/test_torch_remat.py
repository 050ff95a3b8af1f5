"""Rematerialisation in the port (``models/remat.py``): ``remat="full"``
and ``"dots"`` against ``"none"``, and against ``repro``'s remat modes.

Tolerances: in the port, exact (loss and every gradient bit for bit: a
recompute runs the same ops on the same inputs); against ``repro`` at
float32 2e-5 (rtol and atol).  Through a cord dataplane, one step's
records are the same in every mode (the recompute records nothing), and
the dataplane kernel runs once an edge in the forward, once more for each
edge of the recomputed cross-entropy chunk, and with remat once more for
each edge of the recomputed layer bodies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten
from repro_torch.kernels.dataplane import bounce as bk
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.train.step import _value_and_grad

from torch_port_util import bits, jax_params_np, pin_calibration

TOL = dict(rtol=2e-5, atol=2e-5)
MODES = ("none", "full", "dots")


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(params), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    seq = rng.integers(0, tcfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    return jm, params, tcfg, tm, tp, batch


def _port_grads(tm, tp, batch, remat, dp=None):
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return _value_and_grad(lambda p, b: tm.loss(p, b, dp=dp, remat=remat),
                           tp, tb)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none_in_port(models, remat):
    _, _, _, tm, tp, batch = models
    (l0, _), g0 = _port_grads(tm, tp, batch, "none")
    (l1, _), g1 = _port_grads(tm, tp, batch, remat)
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))


@pytest.mark.parametrize("remat", MODES)
def test_remat_matches_jax(models, remat):
    jm, params, _, tm, tp, batch = models
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=remat), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    (tl_, _), tg = _port_grads(tm, tp, batch, remat)
    np.testing.assert_allclose(float(tl_), float(jl), **TOL)
    for (path, t), j in zip(tree_flatten(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=str(path),
                                   **TOL)


def test_records_and_launches_per_remat_mode(models, monkeypatch):
    """Through a cord dataplane with the fused kernel path: the same
    (kind, tag) records in every mode, and the kernel's launches (its
    plain version's calls on the CPU) split as forward edges + the
    cross-entropy chunk's recompute + the layer bodies' recompute."""
    pin_calibration(monkeypatch)
    _, _, tcfg, tm, tp, batch = models
    calls = []
    plain = bk._plain
    monkeypatch.setattr(bk, "_plain", lambda *a: calls.append(1) or
                        plain(*a))
    layer_edges = 7 * tcfg.num_layers
    forward = 4 + layer_edges
    records, launches = {}, {}
    for remat in MODES:
        dp = TDataplane(TCfg(mode="cord", emulate_costs=True,
                             pallas_dataplane="on"),
                        mesh=make_local_mesh(), rules={"batch": "data"},
                        device="cpu")
        calls.clear()
        _port_grads(tm, tp, batch, remat, dp=dp)
        records[remat] = [(r.kind, r.tag) for r in dp.telemetry.records]
        launches[remat] = len(calls)
    assert records["full"] == records["dots"] == records["none"]
    assert len(records["none"]) == forward
    assert launches == {"none": forward + 1,
                        "full": forward + 1 + layer_edges,
                        "dots": forward + 1 + layer_edges}
