"""Port parity for attention and the flash-attention kernel's plain path.

The port's ``ref.py`` and ``ops.flash_attention`` (its plain version on
CPU tensors) are held against repro's ``flash_attention_ref``, the XLA
``attend_flash`` and the Pallas kernel in interpret mode; ``attend_naive``
under a per-slot mask against repro's.  Tolerance: f32 2e-5, as in
tests/test_kernels.py.  The kernel-vs-plain case needs the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro.layers import attention as jatt

from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tref
from repro_torch.layers import attention as tatt

from torch_port_util import cuda_device, to_np

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = [
    # (B, S, H, KVH, D, window, valid_len, logit_cap)
    (1, 16, 4, 1, 16, 0, None, 0.0),     # GQA 4:1, global
    (2, 24, 4, 2, 16, 8, None, 0.0),     # sliding window, ragged S
    (1, 16, 2, 2, 32, 0, 11, 0.0),       # valid_len < S
    (1, 16, 4, 1, 16, 0, None, 5.0),     # logit soft cap
    (1, 8, 2, 1, 16, 4, 0, 0.0),         # every row fully masked -> 0
    # edges of the Hopper kernel's 64-row tiles
    (1, 128, 2, 1, 16, 37, None, 0.0),   # window no multiple of 64
    (1, 128, 2, 1, 16, 0, 70, 0.0),      # valid_len inside a tile
    (1, 1, 2, 1, 16, 0, None, 0.0),      # one query
    (1, 40, 10, 2, 64, 24, None, 0.0),   # GQA 5:1 at D=64
    (1, 24, 12, 2, 16, 0, None, 30.0),   # GQA 6:1 with grok-1's soft cap
    (1, 24, 14, 2, 16, 0, None, 0.0),    # GQA 7:1, as llava-next's 56:8
]


def _block(s):
    """Pallas / XLA block size: small blocks on short sequences, so the
    block skip and carry are exercised; fewer interpret steps on long."""
    return 8 if s <= 64 else 32


def _qkv(b, s, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kvh,d,window,valid,cap", CASES)
def test_ref_matches_jax_ref(b, s, h, kvh, d, window, valid, cap):
    q, k, v = _qkv(b, s, h, kvh, d)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    want = jref(jnp.asarray(tr(q)), jnp.asarray(tr(k)), jnp.asarray(tr(v)),
                window=window, valid_len=valid, logit_cap=cap)
    got = tref(torch.from_numpy(tr(q)), torch.from_numpy(tr(k)),
               torch.from_numpy(tr(v)), window=window, valid_len=valid,
               logit_cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    if valid == 0:
        assert not to_np(got).any()


@pytest.mark.parametrize("b,s,h,kvh,d,window,valid,cap", CASES)
def test_flash_plain_matches_pallas_interpret(b, s, h, kvh, d, window, valid,
                                              cap):
    q, k, v = _qkv(b, s, h, kvh, d, seed=1)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    scal = jnp.asarray([window, s if valid is None else valid], jnp.int32)
    want = flash_attention_fwd(tr(q), tr(k), tr(v), scal, logit_cap=cap,
                               q_block=_block(s), kv_block=_block(s),
                               interpret=True)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window,
                               valid_len=valid, logit_cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(want).transpose(0, 2, 1, 3),
                               **TOL)


@pytest.mark.parametrize("b,s,h,kvh,d,window,valid,cap",
                         [c for c in CASES if c[6] is None])
def test_attend_matches_attend_flash(b, s, h, kvh, d, window, valid, cap):
    """The prefill path: repro's XLA attend_flash is the reference."""
    q, k, v = _qkv(b, s, h, kvh, d, seed=2)
    pos = np.arange(s, dtype=np.int32)
    want = jatt.attend_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                             causal=True, window=window, logit_cap=cap,
                             q_block=_block(s), kv_block=_block(s))
    tpos = torch.from_numpy(pos)
    got = tatt.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), q_pos=tpos, k_pos=tpos,
                      window=window, logit_cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_attend_flash_path_needs_iota_positions():
    q, k, v = (torch.zeros(1, 4, 2, 16) for _ in range(3))
    with pytest.raises(ValueError, match="positions"):
        tatt.attend(q, k, v, q_pos=torch.arange(1, 5),
                    k_pos=torch.arange(1, 5))
    # the prefill's shared positions pass by identity
    pos = tatt.prefill_positions(4, q.device)
    assert pos is tatt.prefill_positions(4, q.device)
    assert pos.dtype == torch.int32 and pos.tolist() == [0, 1, 2, 3]
    assert not tatt.attend(q, k, v, q_pos=pos, k_pos=pos).any()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 0.0), (0, 4.0)])
def test_attend_naive_slot_mask_matches_jax(window, cap):
    b, smax, h, kvh, d = 3, 12, 4, 1, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, kvh, d)).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    kp = np.arange(smax)
    valid = kp[None] <= pos[:, None]
    if window:
        valid &= pos[:, None] - kp[None] < window
    want = jatt.attend_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(valid)[:, None, :], logit_cap=cap)
    got = tatt.attend_naive(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            torch.from_numpy(valid)[:, None, :],
                            logit_cap=cap)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_make_mask_matches_jax():
    qp, kp = np.arange(3, 9), np.arange(10)
    kval = kp < 8
    for causal in (True, False):
        for window in (None, 0, 3):
            want = jatt.make_mask(jnp.asarray(qp), jnp.asarray(kp),
                                  causal=causal, window=window,
                                  k_valid=jnp.asarray(kval))
            got = tatt.make_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                                 causal=causal, window=window,
                                 k_valid=torch.from_numpy(kval))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,kvh,d", [
    (torch.bfloat16, 4, 1, 256),    # gemma3-1b heads
    (torch.bfloat16, 25, 5, 64),    # hymba-1.5b heads
    (torch.bfloat16, 4, 2, 128),
    (torch.bfloat16, 4, 1, 16),     # zero-padded to 64 by the wrapper
    (torch.float32, 4, 1, 16),      # the CUDA-core path
])
def test_kernel_matches_plain_on_card(dtype, h, kvh, d):
    dev = cuda_device()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    # (B, S, window, valid_len): global, windows on and off the 64-row
    # tile grid, valid_len inside a tile, one query, nothing valid, and
    # a second sequence in the batch
    for b, s, window, valid in ((1, 200, 0, None), (1, 200, 64, None),
                                (1, 200, 0, 150), (1, 200, 37, None),
                                (1, 130, 100, None), (1, 1, 0, None),
                                (1, 200, 0, 70), (1, 200, 0, 0),
                                (2, 130, 0, None)):
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in _qkv(b, s, h, kvh, d, seed=5))
        got = tops.flash_attention(q, k, v, window=window, valid_len=valid)
        want = tops.flash_attention_plain(q, k, v, window=window,
                                          valid_len=valid)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if valid == 0:
            assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,s,cap", [
    (48, 8, 256, 30.0),     # grok-1: D 128, GQA 6:1, soft cap 30
    (48, 8, 1100, 30.0),    # grok-1's long prompt, off the tile grid
    (56, 8, 640, 0.0),      # llava-next: D 128, GQA 7:1
])
def test_kernel_matches_plain_at_moe_and_vlm_heads(h, kvh, s, cap):
    """The kernel against its plain version at the heads of the moe and
    vlm families, bf16 (2e-2), with the log-sum-exp at 2e-5 x max(1,
    |lse|) where the train step asks for it."""
    dev = cuda_device()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in _qkv(1, s, h, kvh, 128, seed=7))
    got = tops.flash_attention(q, k, v, logit_cap=cap)
    want = tops.flash_attention_plain(q, k, v, logit_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    o, lse = tops.flash_attention(q, k, v, logit_cap=cap, return_lse=True)
    po, plse = tops.flash_attention_plain(q, k, v, logit_cap=cap,
                                          return_lse=True)
    assert lse.shape == plse.shape == (1, kvh, h // kvh, s)
    lim = 2e-5 * max(1.0, float(plse.abs().max()))
    assert float((lse - plse).abs().max()) <= lim
    torch.testing.assert_close(o.float(), po.float(), rtol=2e-2, atol=2e-2)
