"""The scan's gradient: ``kernels/ssm_scan/ops.SSMScan`` (the kernel
forward and backward on a CUDA tensor; on the CPU their plain versions,
``ref.ssm_scan_ref`` and ``ref.ssm_scan_bwd_plain``) against ``jax.grad``
of ``repro``'s ``ssm_scan_chunked``
and against autograd through the plain time loop ``ssm_scan_ref``.  The
loss is a sum of y * w plus h_final * w', so both outputs carry a
cotangent.  Inputs are made with numpy from a seed.

Tolerance: every input's gradient, h0's included, within 2e-5 *
max(1, |ref|) (f32 on both sides; the backward's chunked scans and the
reference's sums round differently).  The kernel-vs-plain case needs the
card and skips here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.layers.mamba import ssm_scan_chunked as jchunked

from repro_torch.kernels.ssm_scan import ref as sref
from repro_torch.kernels.ssm_scan.ops import SSMScan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

from torch_port_util import cuda_device

F32_TOL = 2e-5
NAMES = ("dt", "x", "a", "b", "c", "h0")


def _inputs(shape, seed=0):
    """numpy (dt, x, a, b, c, h0, w, w'): mamba-like dt (softplus, scaled
    so the state outlives a chunk), A = -exp(0.3 N(0, 1)), nonzero h0,
    and the loss weights."""
    bsz, s, di, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = (0.3 * np.log1p(np.exp(rng.standard_normal((bsz, s, di))))).astype(f)
    x = rng.standard_normal((bsz, s, di)).astype(f)
    a = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(f)
    b = rng.standard_normal((bsz, s, n)).astype(f)
    c = rng.standard_normal((bsz, s, n)).astype(f)
    h0 = rng.standard_normal((bsz, di, n)).astype(f)
    w = rng.standard_normal((bsz, s, di)).astype(f)
    w2 = rng.standard_normal((bsz, di, n)).astype(f)
    return (dt, x, a, b, c, h0), (w, w2)


def _port_grads(arrs, weights, plain=False, device="cpu"):
    leaves = [torch.from_numpy(t.copy()).to(device).requires_grad_()
              for t in arrs]
    y, hf = SSMScan.apply(*leaves, plain)
    w, w2 = (torch.from_numpy(t).to(device) for t in weights)
    loss = (y * w).sum() + (hf * w2).sum()
    return torch.autograd.grad(loss, leaves), y


def _jax_grads(arrs, weights, chunk):
    w, w2 = weights

    def loss(*args):
        y, hf = jchunked(*args, chunk=chunk)
        return (y * w).sum() + (hf * w2).sum()
    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(t) for t in arrs))


def _assert_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    lim = F32_TOL * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"{name}: max err {err.max()}"


# (S, backward chunk): one chunk, several whole chunks, a ragged last one
PLANS = [(20, 64), (48, 16), (37, 16)]


@pytest.mark.parametrize("s,chunk", PLANS)
def test_grad_matches_jax_chunked(s, chunk, monkeypatch):
    monkeypatch.setattr(sref, "BWD_CHUNK", chunk)
    arrs, weights = _inputs((2, s, 24, 8), seed=s)
    got, _ = _port_grads(arrs, weights)
    want = _jax_grads(arrs, weights, chunk=16)
    for name, g, j in zip(NAMES, got, want):
        _assert_close(g.numpy(), j, name)
    # gradients of magnitude O(1): a dropped carry or step moves them
    assert max(float(np.abs(np.asarray(j)).max()) for j in want) > 1.0


@pytest.mark.parametrize("s,chunk", PLANS)
def test_grad_matches_autograd_through_ref(s, chunk, monkeypatch):
    monkeypatch.setattr(sref, "BWD_CHUNK", chunk)
    arrs, weights = _inputs((1, s, 16, 4), seed=100 + s)
    got, _ = _port_grads(arrs, weights)
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in arrs]
    y, hf = ssm_scan_ref(*leaves)
    w, w2 = (torch.from_numpy(t) for t in weights)
    want = torch.autograd.grad((y * w).sum() + (hf * w2).sum(), leaves)
    for name, g, r in zip(NAMES, got, want):
        _assert_close(g.numpy(), r.numpy(), name)


def test_backward_never_holds_the_whole_sequence(monkeypatch):
    """No tensor of the backward spans (B, S, di, N) or more: the states
    are recomputed a chunk at a time."""
    monkeypatch.setattr(sref, "BWD_CHUNK", 8)
    shape = (2, 64, 16, 4)
    arrs, weights = _inputs(shape, seed=3)
    full = int(np.prod(shape))
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    sizes.append(t.numel())
            return out

    t = [torch.from_numpy(a.copy()) for a in arrs]
    with Sizes():
        sref.ssm_scan_bwd_plain(*t, torch.from_numpy(weights[0]),
                                torch.from_numpy(weights[1]))
    assert sizes and max(sizes) <= full // 4


def test_one_cotangent_may_be_absent():
    """Only y feeds the loss: h_final's cotangent is absent (None)."""
    arrs, (w, _) = _inputs((1, 9, 8, 2), seed=5)
    leaves = [torch.from_numpy(t.copy()).requires_grad_() for t in arrs]
    y, _ = SSMScan.apply(*leaves, False)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    want = _jax_grads(arrs, (w, np.zeros_like(arrs[5])), chunk=4)
    for name, g, j in zip(NAMES, got, want):
        _assert_close(g.numpy(), j, name)


def test_kernel_forward_never_falls_back(monkeypatch):
    """On a device with no kernel and no plain fallback (here ``meta``,
    where the kernel's shape rule runs for the cost counter) the forward
    never takes the plain version: it allocates the kernel's outputs,
    adds the kernel's cost and launches nothing."""
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.kernels.ssm_scan import ops

    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ops, "ssm_scan_plain", refuse)
    monkeypatch.setattr(ops, "ssm_scan_ref", refuse)
    arrs, _ = _inputs((1, 4, 8, 2))
    leaves = [torch.from_numpy(t).to("meta").requires_grad_() for t in arrs]
    n0 = ops.LAUNCHES
    with CostCounter() as c:
        y, hf = SSMScan.apply(*leaves, False)
    assert y.is_meta and hf.is_meta and ops.LAUNCHES == n0
    assert (tuple(y.shape), tuple(hf.shape)) == ((1, 4, 8), (1, 8, 2))
    assert c.kernels["ssm_scan"]["calls"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 256])
def test_kernel_forward_and_plain_backward_on_card(s):
    """On the card: the kernel forward and backward inside ``SSMScan``
    against the plain versions inside it (``plain=True``), and the
    gradients against the CPU's."""
    dev = cuda_device()
    arrs, weights = _inputs((2, s, 256, 16), seed=s)
    got, y = _port_grads(arrs, weights, device=dev)
    ref, yp = _port_grads(arrs, weights, plain=True, device=dev)
    cpu, _ = _port_grads(arrs, weights)
    _assert_close(y.detach().cpu().numpy(), yp.detach().cpu().numpy(), "y")
    for name, g, r, c in zip(NAMES, got, ref, cpu):
        _assert_close(g.cpu().numpy(), r.cpu().numpy(), name)
        _assert_close(g.cpu().numpy(), c.numpy(), name)
