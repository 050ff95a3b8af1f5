"""The scan's backward kernel wrapper, ``kernels/ssm_scan/ops.ssm_scan_bwd``.

On the CPU it runs its plain version, ``ref.ssm_scan_bwd_plain``, bit for
bit; that plain version is held against ``jax.grad`` of ``repro``'s
``ssm_scan_chunked``.  On ``meta`` it calls the shape rule
``repro_torch::ssm_scan_bwd``, which ``analysis/cost.CostCounter``
prices.  The kernel path never falls back to the plain version, and
``SSMScan`` takes the wrapper only without ``plain``.  Inputs are made
with numpy from a seed.

Tolerance: f32 gradients within 2e-5 * max(1, |ref|) (the plain version
computes in float64, XLA's gradient in float32).  The ``cuda``-marked
tests hold the kernel against the plain version on the card at the same
bound (bf16 d dt and d x: plus one bf16 ulp of the output) and require
two calls to give identical bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.mamba import ssm_scan_chunked as jchunked

from repro_torch.analysis.cost import CostCounter, ssm_scan_bwd_cost
from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan import ref as sref

from torch_port_util import bits, cuda_device, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_TOL = 2e-5
NAMES = ("dt", "x", "a", "b", "c", "h0")
# (B, S, di, N): one chunk of the kernel's 16 steps, a ragged second
# one, several whole ones, state sizes 1, 4 and 32
SHAPES = [(1, 9, 8, 2), (2, 33, 24, 8), (1, 48, 16, 4), (2, 20, 6, 1),
          (1, 17, 4, 32)]


def _inputs(shape, seed=0):
    """numpy (dt, x, a, b, c, h0) and cotangents (gy, ghf): mamba-like dt
    (softplus, scaled so the state outlives a chunk), A = -exp(0.3 N(0,
    1)), nonzero h0."""
    bsz, s, di, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = (0.3 * np.log1p(np.exp(rng.standard_normal((bsz, s, di))))).astype(f)
    x = rng.standard_normal((bsz, s, di)).astype(f)
    a = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(f)
    b = rng.standard_normal((bsz, s, n)).astype(f)
    c = rng.standard_normal((bsz, s, n)).astype(f)
    h0 = rng.standard_normal((bsz, di, n)).astype(f)
    gy = rng.standard_normal((bsz, s, di)).astype(f)
    ghf = rng.standard_normal((bsz, di, n)).astype(f)
    return (dt, x, a, b, c, h0), (gy, ghf)


def _t(arrs, device="cpu"):
    return [torch.from_numpy(a.copy()).to(device) for a in arrs]


def _assert_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    lim = F32_TOL * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"{name}: max err {err.max()}"


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_grad(shape):
    arrs, (gy, ghf) = _inputs(shape, seed=shape[1])

    def loss(*args):
        y, hf = jchunked(*args, chunk=16)
        return (y * gy).sum() + (hf * ghf).sum()
    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(t) for t in arrs))
    got = ops.ssm_scan_bwd(*_t(arrs), *_t((gy, ghf)))
    for name, g, j in zip(NAMES, got, want):
        _assert_close(g.numpy(), j, name)
    assert max(float(np.abs(np.asarray(j)).max()) for j in want) > 1.0


@pytest.mark.parametrize("which", ["both", "gy", "ghf"])
def test_cpu_wrapper_is_the_plain_version(which):
    arrs, (gy, ghf) = _inputs((2, 21, 12, 4), seed=7)
    cot = (None if which == "ghf" else torch.from_numpy(gy),
           None if which == "gy" else torch.from_numpy(ghf))
    got = ops.ssm_scan_bwd(*_t(arrs), *cot)
    want = sref.ssm_scan_bwd_plain(*_t(arrs), *cot)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and np.array_equal(bits(g), bits(w)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_runs_the_shape_rule_and_is_priced(dtype):
    bsz, s, di, n = 2, 40, 24, 8
    arrs, (gy, ghf) = _inputs((bsz, s, di, n))
    t = [torch.empty(a.shape, device="meta",
                     dtype=dtype if i < 2 else torch.float32)
         for i, a in enumerate(arrs)]
    g = torch.empty(gy.shape, device="meta", dtype=dtype)
    gh = torch.empty(ghf.shape, device="meta")
    n0 = ops.BWD_LAUNCHES
    with CostCounter() as cc:
        grads = ops.ssm_scan_bwd(*t, g, gh)
    assert ops.BWD_LAUNCHES == n0
    for name, got, want in zip(NAMES, grads, t):
        assert got.is_meta and got.shape == want.shape, name
        assert got.dtype == want.dtype, name
    k = cc.kernels["ssm_scan_bwd"]
    flops, nbytes = ssm_scan_bwd_cost(bsz, s, di, n, t[0].element_size())
    assert (k["calls"], k["flops"], k["bytes"]) == (1, flops, nbytes)
    assert flops == 20 * bsz * s * di * n


def test_function_on_meta_never_falls_back(monkeypatch):
    """``SSMScan`` forward and backward on ``meta``: both shape rules run,
    neither plain version does, nothing is launched."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran")

    for name in ("ssm_scan_plain", "ssm_scan_ref", "ssm_scan_bwd_plain"):
        monkeypatch.setattr(ops, name, refuse)
    arrs, _ = _inputs((1, 20, 8, 4))
    leaves = [torch.from_numpy(a).to("meta").requires_grad_() for a in arrs]
    n0, b0 = ops.LAUNCHES, ops.BWD_LAUNCHES
    with CostCounter() as cc:
        y, hf = ops.SSMScan.apply(*leaves, False)
        grads = torch.autograd.grad((y.sum(), hf.sum()), leaves)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (n0, b0)
    assert all(g.is_meta and g.shape == t.shape
               for g, t in zip(grads, leaves))
    assert cc.kernels["ssm_scan"]["calls"] == 1
    assert cc.kernels["ssm_scan_bwd"]["calls"] == 1


def test_kernel_path_raises_and_never_falls_back(monkeypatch):
    """Where the kernel cannot be built the kernel path raises: it never
    runs the plain version instead, and counts no launch."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    def no_kernel(*a, **k):
        raise build.KernelBuildError("no kernel here")

    monkeypatch.setattr(ops, "ssm_scan_bwd_plain", refuse)
    monkeypatch.setattr(ops, "_BWD_FN", None)
    monkeypatch.setattr(build, "function", no_kernel)
    arrs, cot = _inputs((1, 6, 4, 2))
    b0 = ops.BWD_LAUNCHES
    with pytest.raises(build.KernelBuildError):
        ops._bwd_kernel(*_t(arrs), *_t(cot))
    assert ops.BWD_LAUNCHES == b0


@pytest.mark.parametrize("plain", [False, True])
def test_function_takes_the_wrapper_only_without_plain(plain, monkeypatch):
    calls = []
    wrapper, plain_bwd = ops.ssm_scan_bwd, ops.ssm_scan_bwd_plain
    monkeypatch.setattr(ops, "ssm_scan_bwd", lambda *a: calls.append(
        "wrapper") or wrapper(*a))
    monkeypatch.setattr(ops, "ssm_scan_bwd_plain", lambda *a: calls.append(
        "plain") or plain_bwd(*a))
    arrs, (gy, _) = _inputs((1, 18, 8, 4), seed=2)
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]
    y, _ = ops.SSMScan.apply(*leaves, plain)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), leaves)
    # on the CPU the wrapper itself runs the plain version
    assert calls == (["plain"] if plain else ["wrapper", "plain"])
    want = sref.ssm_scan_bwd_plain(*_t(arrs), torch.from_numpy(gy), None)
    for name, g, w in zip(NAMES, got, want):
        assert np.array_equal(bits(g), bits(w)), name


def test_check_names_a_wrong_cotangent():
    arrs, (gy, ghf) = _inputs((1, 5, 4, 2))
    t = _t(arrs)
    with pytest.raises(ValueError, match="gy must be"):
        ops._check_bwd(*t, torch.from_numpy(gy).double(), None)
    with pytest.raises(ValueError, match="ghf must be"):
        ops._check_bwd(*t, None, torch.from_numpy(ghf)[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_bwd(*t, torch.from_numpy(gy).transpose(1, 2)
                       .contiguous().transpose(1, 2), None)


# (shape, dtype, which cotangents, mamba's own dt and A); the kernel's
# edges: one step, one step past a whole number of its 8-step tiles, four
# batch rows, ragged channel blocks, every state size
CARD_CASES = [((2, 37, 200, 16), torch.float32, "both", False),
              ((1, 300, 256, 16), torch.float32, "both", True),
              ((2, 64, 96, 1), torch.float32, "gy", False),
              ((1, 40, 64, 32), torch.float32, "ghf", False),
              ((2, 33, 128, 4), torch.bfloat16, "both", False),
              ((1, 1, 96, 16), torch.float32, "both", False),
              ((2, 257, 200, 16), torch.float32, "both", True),
              ((4, 40, 160, 16), torch.float32, "both", True),
              ((2, 45, 300, 1), torch.bfloat16, "both", False),
              ((1, 41, 50, 32), torch.bfloat16, "both", False),
              ((2, 25, 72, 2), torch.float32, "ghf", False),
              ((1, 30, 100, 8), torch.bfloat16, "gy", True)]


def _card_inputs(shape, dtype, long_memory, seed):
    arrs, cot = _inputs(shape, seed=seed)
    dev = cuda_device()
    if long_memory:
        bsz, s, di, n = shape
        rng = np.random.default_rng(seed)
        dt = np.exp(np.log(1e-3) + rng.random((bsz, s, di)) * np.log(100.0))
        arrs = (dt.astype(np.float32), arrs[1],
                -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                 (di, n)).copy(), *arrs[3:])
    t = _t(arrs, dev)
    t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
    gy, ghf = _t(cot, dev)
    return t, gy.to(dtype), ghf


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,which,long_memory", CARD_CASES)
def test_kernel_matches_plain_on_card(shape, dtype, which, long_memory):
    t, gy, ghf = _card_inputs(shape, dtype, long_memory, seed=shape[1])
    cot = (None if which == "ghf" else gy, None if which == "gy" else ghf)
    b0 = ops.BWD_LAUNCHES
    got = ops.ssm_scan_bwd(*t, *cot)
    again = ops.ssm_scan_bwd(*t, *cot)
    want = sref.ssm_scan_bwd_plain(*t, *cot)
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES - b0 == 2
    for name, g, g2, w in zip(NAMES, got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.contiguous().view(torch.uint8),
                           g2.contiguous().view(torch.uint8)), name
        gf, wf = g.float(), w.float()
        lim = F32_TOL * wf.abs().clamp(min=1.0)
        if g.dtype == torch.bfloat16:
            lim = lim + torch.exp2(torch.floor(torch.log2(torch.maximum(
                gf.abs(), wf.abs()).clamp(min=2.0 ** -126))) - 7)
        err = (gf - wf).abs()
        assert bool((err <= lim).all()), f"{name}: max err {err.max()}"


@pytest.mark.cuda
def test_function_launches_both_kernels_on_card():
    t, gy, ghf = _card_inputs((2, 48, 128, 16), torch.float32, True, seed=1)
    leaves = [x.clone().requires_grad_() for x in t]
    n0, b0 = ops.LAUNCHES, ops.BWD_LAUNCHES
    y, hf = ops.SSMScan.apply(*leaves, False)
    got = torch.autograd.grad((y * gy).sum() + (hf * ghf).sum(), leaves)
    assert (ops.LAUNCHES - n0, ops.BWD_LAUNCHES - b0) == (1, 1)
    want = sref.ssm_scan_bwd_plain(*t, gy, ghf)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(g.cpu().numpy(), w.cpu().numpy(), name)


@pytest.mark.cuda
def test_kernel_far_range_on_card():
    """Tiles where |dt a| reaches 700 take libdevice's exp: dt of 750 and
    2,000 at a few steps and channels (the factor underflows to 0 there),
    held against the plain version at the same bound, bits equal twice."""
    t, gy, ghf = _card_inputs((2, 41, 100, 16), torch.float32, False, seed=5)
    t[0][:, 17, :5] = 750.0
    t[0][1, 30, 3] = 2000.0
    got = ops.ssm_scan_bwd(*t, gy, ghf)
    again = ops.ssm_scan_bwd(*t, gy, ghf)
    want = sref.ssm_scan_bwd_plain(*t, gy, ghf)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(NAMES, got, again, want):
        assert np.array_equal(bits(g), bits(g2)), name
        _assert_close(g.cpu().numpy(), w.cpu().numpy(), name)
