"""Port parity for attention with a gradient: the ``FlashAttention``
autograd function (``layers/attention.py``) and the flash kernel's
log-sum-exp (``kernels/flash_attention``).

The JAX side is ``repro``'s ``attend_flash`` (its custom-VJP blocked
attention) under ``jax.grad``, and its ``_flash_fwd_impl`` for the lse.
Tolerance: float32 2e-5 (rtol and atol), as tests/test_kernels.py holds
f32.  The ``cuda``-marked tests hold the kernel's lse against its plain
version on the card: 2e-5 for f32 and bf16 inputs alike (the lse is
computed in f32 from the same products), outputs at 2e-5 (f32) and 1e-2
(bf16, chip_smoke.py's bound)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.attention import _flash_fwd_impl, attend_flash

from repro_torch.kernels.flash_attention import ops
from repro_torch.layers.attention import (
    FlashAttention,
    attend,
    flash_attention_bwd,
    prefill_positions,
)

from torch_port_util import cuda_device, to_np

TOL = dict(rtol=2e-5, atol=2e-5)
# (B, S, H, KVH, D, window, logit_cap)
CASES = [(2, 24, 4, 2, 16, 0, 0.0), (2, 24, 4, 2, 16, 8, 0.0),
         (1, 32, 4, 1, 16, 0, 30.0), (2, 16, 2, 2, 32, 5, 5.0)]


def _inputs(case, seed=0):
    b, s, h, kvh, d, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, w


def _jax_grads(q, k, v, w, window, cap, q_block=512, kv_block=1024):
    pos = jnp.arange(q.shape[1], dtype=jnp.int32)

    def loss(q, k, v):
        o = attend_flash(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                         window=window, logit_cap=cap, q_block=q_block,
                         kv_block=kv_block)
        return jnp.sum(o * w), o
    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.mark.parametrize("case", CASES)
def test_function_grads_match_jax(case):
    q, k, v, w = _inputs(case)
    window, cap = case[5], case[6]
    jo, jg = _jax_grads(q, k, v, w, window, cap)
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (q, k, v))
    pos = prefill_positions(q.shape[1], torch.device("cpu"))
    o = attend(tq, tk, tv, q_pos=pos, k_pos=pos, causal=True, window=window,
               logit_cap=cap)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(o), jo, **TOL)
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(to_np(t.grad), j, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_blockwise_backward_matches_jax(case):
    """Several q and kv blocks (4 and 8 rows): the same block order and
    accumulation as ``repro``'s ``_flash_bwd``."""
    q, k, v, w = _inputs(case, seed=1)
    window, cap = case[5], case[6]
    _, jg = _jax_grads(q, k, v, w, window, cap, q_block=4, kv_block=8)
    tq, tk, tv = (torch.from_numpy(x.copy()) for x in (q, k, v))
    o, lse = ops.flash_attention_plain(tq, tk, tv, window=window,
                                       logit_cap=cap, return_lse=True)
    grads = flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(w),
                                causal=True, window=window, logit_cap=cap,
                                q_block=4, kv_block=8)
    for t, j in zip(grads, jg):
        np.testing.assert_allclose(to_np(t), j, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_matches_flash_fwd_impl(case):
    q, k, v, _ = _inputs(case, seed=2)
    b, s, h, kvh, d, window, cap = case
    pos = jnp.arange(s, dtype=jnp.int32)
    jo, jlse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               pos, pos, jnp.asarray(window),
                               jnp.ones(s, bool), True, cap, 512, 1024,
                               1.0 / math.sqrt(d))
    to, tlse = ops.flash_attention_plain(*(torch.from_numpy(x.copy())
                                           for x in (q, k, v)),
                                         window=window, logit_cap=cap,
                                         return_lse=True)
    assert tuple(tlse.shape) == jlse.shape == (b, kvh, h // kvh, s)
    np.testing.assert_allclose(to_np(tlse), np.asarray(jlse), **TOL)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)


def test_lse_refuses_rows_without_keys():
    q = torch.ones(1, 16, 2, 16)
    kv = torch.ones(1, 16, 1, 16)
    for kw in (dict(valid_len=0), dict(window=4, valid_len=12)):
        with pytest.raises(ValueError, match="no key"):
            ops.flash_attention(q, kv, kv, return_lse=True, **kw)
    # the same masks without lse keep the kernel's zero rows
    assert torch.equal(ops.flash_attention(q, kv, kv, valid_len=0),
                       torch.zeros_like(q))


def test_no_grad_and_plain_impl_take_no_function():
    q, k, v, _ = _inputs(CASES[0])
    tq, tk, tv = (torch.from_numpy(x.copy()) for x in (q, k, v))
    pos = prefill_positions(q.shape[1], torch.device("cpu"))
    a = attend(tq, tk, tv, q_pos=pos, k_pos=pos, impl="flash")
    b = attend(tq, tk, tv, q_pos=pos, k_pos=pos, impl="plain")
    assert a.grad_fn is None and torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (dtype, B, S, H, KVH, D, window): the train shapes of gemma3-1b (bf16,
# D=256, S=256) and smoke shapes through the f32 path
CARD_CASES = [(torch.bfloat16, 2, 256, 4, 1, 256, 512),
              (torch.bfloat16, 2, 256, 4, 1, 256, 0),
              (torch.bfloat16, 1, 200, 4, 2, 64, 100),
              (torch.float32, 2, 24, 4, 2, 16, 8),
              (torch.float32, 1, 70, 2, 1, 64, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_kernel_lse_matches_plain(case):
    dev = cuda_device()
    dtype, b, s, h, kvh, d, window = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (3 * torch.randn(b, s, h, d, generator=gen, device=dev)).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=gen, device=dev).to(dtype)
    # values in [-1.5, 1.5) keep |o| < 2, where a bf16 ulp is 2^-7 < 1e-2
    v = (torch.rand(b, s, kvh, d, generator=gen, device=dev) * 3 - 1.5
         ).to(dtype)
    n0 = (ops.LAUNCHES, ops.LSE_LAUNCHES)
    o, lse = ops.flash_attention(q, k, v, window=window, return_lse=True)
    po, plse = ops.flash_attention_plain(q, k, v, window=window,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LSE_LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    assert lse.shape == plse.shape == (b, kvh, h // kvh, s)
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), po.float(), rtol=0, atol=tol)
    # without lse the kernel gives the same output
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=window),
                               o, rtol=0, atol=0)


@pytest.mark.cuda
def test_card_function_grads_match_plain_forward():
    """The kernel forward and the plain forward inside the same autograd
    function give the same gradients (f32 path, 2e-5)."""
    dev = cuda_device()
    q, k, v, w = (torch.from_numpy(x).to(dev)
                  for x in _inputs(CASES[2], seed=3))
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = FlashAttention.apply(*leaves, True, 0, 30.0, plain)
        (o * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
