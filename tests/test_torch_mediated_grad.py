"""Gradients across mediated edges, and the edges of the loss.

* The dataplane kernel's autograd function (``kernels/dataplane/
  bounce.py``): the output is a copy of ``x``, so the backward is the
  identity on the cotangent, as through ``repro``'s ``tie`` and
  ``staged_copy``; it launches nothing, and the counters carry no
  gradient.  On the CPU the same function runs the kernel's plain
  version; the ``cuda`` tests hold the kernel itself.
* ``model.loss(..., dp=dp)`` issues ``repro``'s edges, ``loss/logits``
  included (one a cross-entropy chunk), in ``repro``'s order, with the
  layer body once per layer (the port records every executed edge).

Tolerance: exact (gradients bit for bit, records field for field)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.core.dataplane import Dataplane as JDataplane
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core import techniques as tech
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.kernels.dataplane import bounce as bk
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params

from torch_port_util import bits, cuda_device, jax_params_np, pin_calibration


def _payload(device, shape=(3, 40, 70), transpose=False):
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(shape, generator=gen, device=device)
    if transpose:
        x = x.transpose(0, 2)
    g = torch.randn(x.shape, generator=gen, device=device)
    return x.requires_grad_(True), g


def _edges(dk):
    """(name, fn) of every entry point that reaches the kernel."""
    return [("mediated_cost", lambda x: dk.mediated_cost(x, 5000, 0)),
            ("mediated_cost+copy", lambda x: dk.mediated_cost(x, 300, 2)),
            ("bounce_copy", lambda x: (dk.bounce_copy(x, 1), None)),
            ("bounce_copy x3", lambda x: (dk.bounce_copy(x, 3), None))]


def _check_identity_backward(device):
    for transpose in (False, True):
        for name, fn in _edges(bk):
            x, g = _payload(device, transpose=transpose)
            out, ctrs = fn(x)
            assert out.grad_fn is not None, name
            assert np.array_equal(bits(out), bits(x)), name
            if ctrs is not None:
                assert not ctrs.requires_grad, name
            n0 = bk.LAUNCHES
            (gx,) = torch.autograd.grad(out, x, g)
            assert bk.LAUNCHES == n0, f"{name}: the backward launched"
            np.testing.assert_array_equal(bits(gx), bits(g), err_msg=name)


def test_wrapper_backward_is_the_identity():
    _check_identity_backward(torch.device("cpu"))


def test_techniques_and_constrain_pass_gradients():
    """``delay_chain``, ``staged_copy`` and a cord edge with cost
    emulation and zero copy removed pass the cotangent unchanged."""
    x, g = _payload("cpu")
    for fn in (lambda t: tech.delay_chain(t, 400),
               lambda t: tech.staged_copy(t, 2)):
        (gx,) = torch.autograd.grad(fn(x), x, g)
        np.testing.assert_array_equal(bits(gx), bits(g))
    for pallas in ("on", "off"):
        dp = TDataplane(TCfg(mode="socket", emulate_costs=True,
                             pallas_dataplane=pallas),
                        mesh=make_mesh((1,), ("data",)), device="cpu")
        y = dp.constrain(x, ("batch", None, None), tag="edge")
        (gx,) = torch.autograd.grad(y, x, g)
        np.testing.assert_array_equal(bits(gx), bits(g))


def test_no_grad_input_takes_no_autograd_node():
    x = torch.ones(10)
    out, ctrs = bk.mediated_cost(x, 100, 1)
    assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        out, _ = bk.mediated_cost(x.requires_grad_(True), 100, 1)
    assert out.grad_fn is None


def test_loss_records_match_jax(monkeypatch):
    """The loss's edges through a cord dataplane: ``repro``'s records of
    one trace, the layer body repeated per layer, ``loss/table`` and one
    ``loss/logits`` per cross-entropy chunk last; the loss equals the
    loss with ``dp=None`` bit for bit."""
    pin_calibration(monkeypatch)
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    from repro.core import compat
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True),
                     mesh=compat.make_mesh((8,), ("data",)),
                     rules={"batch": "data"})
    rng = np.random.default_rng(0)
    seq = rng.integers(0, jcfg.vocab_size, (8, 17)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    jl, _ = jm.loss(params, {k: jax.numpy.asarray(v)
                             for k, v in batch.items()}, dp=jdp)

    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)),
                     rules={"batch": "data"}, device="cpu")
    tp = from_jax_params(jax_params_np(params), tcfg, "cpu")
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tl_, _ = tm.loss(tp, tb, dp=tdp)
    bare, _ = tm.loss(tp, tb)
    np.testing.assert_allclose(float(tl_), float(jl), rtol=2e-5)
    assert torch.equal(tl_, bare)

    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    body = [r for r in jrecs if r["tag"].startswith(("attn/", "mlp/",
                                                     "layer/"))]
    head, tail = jrecs[:2], jrecs[2 + len(body):]
    assert [r["tag"] for r in head] == ["embed/table", "embed/out"]
    assert [r["tag"] for r in tail] == ["loss/table", "loss/logits"]
    assert tail[1]["shape"] == (8, 16, jcfg.vocab_size)
    want = head + body * tcfg.num_layers + tail
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want


@pytest.mark.cuda
def test_gradient_crosses_kernel_unchanged_on_card():
    """On the card, through ``mediated_cost`` and ``bounce_copy``: the
    kernel launches once a call in the forward and never in the
    backward, and the gradient is the cotangent bit for bit."""
    dev = cuda_device()
    n0 = bk.LAUNCHES
    _check_identity_backward(dev)
    assert bk.LAUNCHES - n0 == 2 * len(_edges(bk))


@pytest.mark.cuda
def test_gradient_crosses_cord_edge_on_card():
    """A cord edge with cost emulation (one ``mediated_cost`` launch) and
    a socket edge (``bounce_copy`` passes and the delay chain) inside a
    loss: the gradients equal the ones without a dataplane, bit for
    bit."""
    dev = cuda_device()
    x, _ = _payload(dev, shape=(4, 64, 128))
    w = torch.randn(128, 32, device=dev)
    (want,) = torch.autograd.grad(torch.tanh(x @ w).sum(), x)
    for mode in ("cord", "socket"):
        for pallas in ("on", "off"):
            dp = TDataplane(TCfg(mode=mode, emulate_costs=True,
                                 pallas_dataplane=pallas),
                            mesh=make_mesh((1,), ("data",)), device=dev)
            n0 = bk.LAUNCHES
            y = dp.constrain(x, ("batch", None, None), tag="edge")
            assert bk.LAUNCHES > n0
            (got,) = torch.autograd.grad(torch.tanh(y @ w).sum(), x)
            np.testing.assert_array_equal(bits(got), bits(want),
                                          err_msg=f"{mode} {pallas}")
