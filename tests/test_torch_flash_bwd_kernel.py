"""The flash backward kernel's wrapper,
``kernels/flash_attention/ops.flash_attention_bwd``.

On the CPU it runs its plain version, ``ref.flash_attention_bwd_plain``,
bit for bit; that plain version is held against ``jax.grad`` through
``repro``'s ``attend_flash`` (its custom-VJP ``_flash_bwd``) at causal,
windowed, soft-capped, GQA and non-causal Sq != Skv shapes.  On ``meta``
it calls the shape rule ``repro_torch::flash_attention_bwd``, which
``analysis/cost.CostCounter`` prices.  The kernel path never falls back
to the plain version, and ``FlashAttention`` takes the wrapper only
without ``plain``.  Inputs are made with numpy from a seed.

Tolerance: f32 gradients within 2e-5 * max(1, |ref|) (both sides in
float32, summed in other orders).  The ``cuda``-marked tests hold the
kernel against the plain version on the card: f32 within 2e-5 * max(1,
|plain|); bf16 (the kernel's products run on the tensor cores with P
and dS rounded to bf16, as the forward rounds P) each gradient at cosine
> 0.999 and max error within 2e-2 * max |plain|; and two calls give
identical bits.  ``_panel_pad``, which widens bf16 D of 16 and 32 to the
bf16 kernels' 64 columns, is held on the CPU: zeros appended, dot
products exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.attention import attend_flash

from repro_torch.analysis.cost import CostCounter, attention_pairs
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.layers import attention as tattn

from torch_port_util import bits, cuda_device, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32_TOL = 2e-5
BF16_COS = 0.999
BF16_REL = 2e-2
# (B, Sq, Skv, H, KVH, D, causal, window, logit_cap)
CASES = [(2, 24, 24, 4, 2, 16, True, 0, 0.0),
         (1, 40, 40, 4, 1, 32, True, 7, 0.0),
         (1, 32, 32, 6, 2, 16, True, 0, 30.0),
         (2, 12, 30, 2, 2, 16, False, 0, 0.0),
         (1, 20, 20, 2, 1, 64, False, 0, 5.0)]
IDS = ["gqa", "window", "cap", "cross", "noncausal-cap"]


def _inputs(case, seed=0):
    b, sq, skv, h, kvh, d = case[:6]
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, sq, h, d)).astype(f)
    k = rng.standard_normal((b, skv, kvh, d)).astype(f)
    v = rng.standard_normal((b, skv, kvh, d)).astype(f)
    do = rng.standard_normal((b, sq, h, d)).astype(f)
    return q, k, v, do


def _kw(case):
    return dict(causal=case[6], window=case[7], logit_cap=case[8])


def _forward(q, k, v, case):
    return ops.flash_attention_plain(q, k, v, return_lse=True, **_kw(case))


def _assert_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    lim = F32_TOL * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"{name}: max err {err.max()}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_grad(case):
    q, k, v, do = _inputs(case, seed=1)
    causal, window, cap = case[6:]
    qp = jnp.arange(q.shape[1], dtype=jnp.int32)
    kp = jnp.arange(k.shape[1], dtype=jnp.int32)

    def loss(q, k, v):
        o = attend_flash(q, k, v, q_pos=qp, k_pos=kp, causal=causal,
                         window=window, logit_cap=cap)
        return jnp.sum(o * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t)
                                              for t in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(t.copy()) for t in (q, k, v, do))
    o, lse = _forward(tq, tk, tv, case)
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **_kw(case))
    for name, g, j in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g.numpy(), np.asarray(j), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_cpu_wrapper_is_the_plain_version(case, dtype):
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in _inputs(case, 2))
    o, lse = _forward(q, k, v, case)
    want = fref.flash_attention_bwd_plain(q, k, v, o, lse, do, **_kw(case))
    for fn in (ops.flash_attention_bwd, tattn.flash_attention_bwd):
        got = fn(q, k, v, o, lse, do, **_kw(case))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype and np.array_equal(bits(g), bits(w)), \
                name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_meta_runs_the_shape_rule_and_is_priced(case, dtype):
    b, sq, skv, h, kvh, d, causal, window, _ = case
    q, do, o = (torch.empty((b, sq, h, d), dtype=dtype, device="meta")
                for _ in range(3))
    k, v = (torch.empty((b, skv, kvh, d), dtype=dtype, device="meta")
            for _ in range(2))
    lse = torch.empty((b, kvh, h // kvh, sq), device="meta")
    n0 = ops.BWD_LAUNCHES
    with CostCounter() as cc:
        grads = ops.flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    assert ops.BWD_LAUNCHES == n0
    for g, t in zip(grads, (q, k, v)):
        assert g.is_meta and g.shape == t.shape and g.dtype == dtype
    kc = cc.kernels["flash_attention_bwd"]
    pairs = attention_pairs(sq, skv, causal, window)
    nbytes = ((4 * b * sq * h + 4 * b * skv * kvh) * d * q.element_size()
              + 4 * b * h * sq)
    assert (kc["calls"], kc["flops"], kc["bytes"]) == (
        1, 10 * d * h * b * pairs, nbytes)


def test_function_on_meta_never_falls_back(monkeypatch):
    """``FlashAttention`` forward and backward on ``meta``: both shape
    rules run, neither plain version does, nothing is launched."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran")

    for name in ("flash_attention_plain", "flash_attention_ref",
                 "flash_attention_bwd_plain"):
        monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(fref, "flash_attention_bwd_plain", refuse)
    q, k, v = (torch.empty(s, device="meta", requires_grad=True)
               for s in ((1, 32, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    n0 = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    with CostCounter() as cc:
        o = tattn.FlashAttention.apply(q, k, v, True, 8, 0.0, False)
        grads = torch.autograd.grad(o.sum(), (q, k, v))
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == n0
    assert all(g.is_meta and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))
    assert cc.kernels["flash_attention"]["calls"] == 1
    assert cc.kernels["flash_attention_bwd"]["calls"] == 1


def test_kernel_path_raises_and_never_falls_back(monkeypatch):
    """Where the kernel cannot be built the kernel path raises: it never
    runs the plain version instead, and counts no launch."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    def no_kernel(*a, **k):
        raise build.KernelBuildError("no kernel here")

    monkeypatch.setattr(ops, "flash_attention_bwd_plain", refuse)
    monkeypatch.setattr(ops, "_BWD_FN", None)
    monkeypatch.setattr(build, "function", no_kernel)
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(CASES[0]))
    o, lse = _forward(q, k, v, CASES[0])
    n0 = ops.BWD_LAUNCHES
    with pytest.raises(build.KernelBuildError):
        ops._bwd_kernel(q, k, v, o, lse, do, **_kw(CASES[0]))
    assert ops.BWD_LAUNCHES == n0


@pytest.mark.parametrize("plain", [False, True])
def test_function_takes_the_wrapper_only_without_plain(plain, monkeypatch):
    calls = []
    wrapper, plain_bwd = tattn.flash_attention_bwd, \
        fref.flash_attention_bwd_plain
    monkeypatch.setattr(tattn, "flash_attention_bwd", lambda *a, **k: (
        calls.append("wrapper") or wrapper(*a, **k)))
    monkeypatch.setattr(fref, "flash_attention_bwd_plain", lambda *a, **k: (
        calls.append("plain") or plain_bwd(*a, **k)))
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(case, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tattn.FlashAttention.apply(*leaves, True, 0, case[8], plain)
    got = torch.autograd.grad((o * do).sum(), leaves)
    assert calls == (["plain"] if plain else ["wrapper"])
    po, lse = _forward(q, k, v, case)
    want = plain_bwd(q, k, v, po, lse, do, **_kw(case))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.array_equal(bits(g), bits(w)), name


@pytest.mark.parametrize("dtype,d,width", [(torch.bfloat16, 16, 64),
                                           (torch.bfloat16, 32, 64),
                                           (torch.bfloat16, 64, 64),
                                           (torch.float32, 16, 16)])
def test_panel_pad_widens_only_narrow_bf16(dtype, d, width):
    rng = np.random.default_rng(d)
    q, k = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((1, 5, 2, d), (1, 7, 1, d)))
    pq, pk = ops._panel_pad(q, k)
    assert pq.shape[-1] == pk.shape[-1] == width
    assert torch.equal(pq[..., :d], q) and torch.equal(pk[..., :d], k)
    assert not pq[..., d:].any() and not pk[..., d:].any()
    dots = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    assert torch.equal(torch.einsum("bqhd,bkhd->bhqk", pq.float(),
                                    pk.float()), dots)


def test_check_names_a_wrong_lse():
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(case))
    o, lse = _forward(q, k, v, case)
    with pytest.raises(ValueError, match="lse must be"):
        ops._check_bwd(q, k, v, o, lse.reshape(q.shape[0], -1, q.shape[1]),
                       do)
    with pytest.raises(ValueError, match="do must be"):
        ops._check_bwd(q, k, v, o, lse, do.double())


def test_check_names_an_unaligned_do():
    """The f32 kernels copy dO in 16-byte chunks: a do that starts off a
    16-byte boundary is refused, not read."""
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(case))
    o, lse = _forward(q, k, v, case)
    shifted = torch.empty(do.numel() + 1)[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="do must be 16-byte aligned"):
        ops._check_bwd(q, k, v, o.contiguous(), lse, shifted)


# the train shapes' masks at a small size: (B, Sq, Skv, H, KVH, D,
# causal, window, logit_cap)
CARD_CASES = [(2, 256, 256, 4, 1, 256, True, 512, 0.0),
              (2, 200, 200, 4, 1, 256, True, 64, 0.0),
              (1, 256, 256, 48, 8, 128, True, 0, 30.0),
              (2, 256, 256, 25, 5, 64, True, 100, 0.0),
              (1, 300, 300, 12, 12, 64, False, 0, 0.0),
              (1, 100, 300, 12, 12, 64, False, 0, 0.0),
              (2, 64, 64, 4, 1, 16, True, 8, 0.0),
              (1, 96, 96, 4, 2, 32, True, 0, 0.0),
              # the bf16 tensor-core design's edges: D 256 with a binding
              # window at a group of 4; D 128 with the soft cap at a group
              # of 6; ragged Sq != Skv with a group of 2; a grid of two
              # dK/dV blocks, which bwd_plan cuts into runs
              (1, 384, 384, 8, 2, 256, True, 100, 0.0),
              (2, 320, 320, 12, 2, 128, True, 0, 30.0),
              (2, 70, 333, 6, 3, 64, False, 0, 0.0),
              (1, 128, 128, 2, 1, 128, True, 0, 0.0)]


def _card_inputs(case, dtype, seed):
    dev = cuda_device()
    q, k, v, do = (torch.from_numpy(t).to(dev).to(dtype)
                   for t in _inputs(case, seed))
    q = q * 2
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **_kw(case))
    return q, k, v, o, lse, do


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    q, k, v, o, lse, do = _card_inputs(case, dtype, seed=case[1])
    n0 = ops.BWD_LAUNCHES
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    want = fref.flash_attention_bwd_plain(q, k, v, o, lse, do, **_kw(case))
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES - n0 == 2
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           g2.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32)), name
        gf, wf = g.float(), w.float()
        err = (gf - wf).abs()
        if dtype == torch.float32:
            assert bool((err <= F32_TOL * wf.abs().clamp(min=1.0)).all()), \
                f"{name}: max err {err.max()}"
        else:
            assert _cos(gf, wf) > BF16_COS, name
            assert err.max() <= BF16_REL * wf.abs().max(), name


@pytest.mark.cuda
def test_function_launches_both_kernels_on_card():
    case = CARD_CASES[3]
    dev = cuda_device()
    q, k, v, do = (torch.from_numpy(t).to(dev) for t in _inputs(case, 5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0, b0 = ops.LSE_LAUNCHES, ops.BWD_LAUNCHES
    o = tattn.FlashAttention.apply(*leaves, True, case[7], 0.0, False)
    got = torch.autograd.grad((o * do).sum(), leaves)
    assert (ops.LSE_LAUNCHES - n0, ops.BWD_LAUNCHES - b0) == (1, 1)
    po, lse = ops.flash_attention_plain(q, k, v, window=case[7],
                                        return_lse=True)
    want = fref.flash_attention_bwd_plain(q, k, v, po, lse, do, causal=True,
                                          window=case[7])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g.cpu().numpy(), w.cpu().numpy(), name)
