"""The Hopper SSM-scan kernel's chunked algorithm (``kernels/ssm_scan``).

``ssm_scan_chunked_ref`` (the kernel's chunk plan, per-chunk decay as a
product of step factors, carry, rescan, in plain torch) is held against
repro's ``ssm_scan_ref`` on inputs made with numpy; ``chunk_plan`` is
checked to cover every sequence exactly with no empty chunk.  Tolerance:
y and h_final within 2e-5 * max(1, |ref|) (both sides compute in f32;
the carry's product form and the sum over N round differently).  The
kernel-vs-plain cases need the card and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jssm_ref

from repro_torch.kernels.ssm_scan import ops as tops
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_chunked_ref,
                                              ssm_scan_ref)

from torch_port_util import cuda_device, to_np

F32_TOL = 2e-5


def _inputs(shape, seed=0):
    """numpy (dt, x, a, b, c, h0) as ``_ssm_inputs`` in chip_smoke.py makes
    them: dt = softplus(N(0, 1)), A = -exp(0.3 N(0, 1)), nonzero h0."""
    bsz, s, di, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, di)))).astype(f)
    x = rng.standard_normal((bsz, s, di)).astype(f)
    a = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(f)
    b = rng.standard_normal((bsz, s, n)).astype(f)
    c = rng.standard_normal((bsz, s, n)).astype(f)
    h0 = rng.standard_normal((bsz, di, n)).astype(f)
    return dt, x, a, b, c, h0


def assert_f32_close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    lim = tol * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"max err {err.max()} (limit {lim.max()})"


# (S, requested chunk count, d_inner); chunk count None is the kernel's
# own plan at that shape
CASES = [(s, k, di) for s in (1, 37, 300, 2048) for k in (1, 2, 7, s)
         for di in ((64,) if s == 2048 else (64, 256))]
CASES += [(300, None, 96), (2048, None, 128)]


@pytest.mark.parametrize("s,k,di", CASES)
def test_chunked_matches_jax_ref(s, k, di):
    arrs = _inputs((1, s, di, 16), seed=s + di)
    chunk_len, n_chunks = tops.chunk_plan(1, s, di, n_chunks=k)
    y, hf = ssm_scan_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                                 chunk_len, n_chunks)
    yr, hr = jssm_ref(*(jnp.asarray(a) for a in arrs))
    assert_f32_close(to_np(y), yr)
    assert_f32_close(to_np(hf), hr)
    # outputs of magnitude O(1): a dropped carry or step moves them by O(1)
    assert np.abs(np.asarray(yr)).max() > 1.0


@pytest.mark.parametrize("bsz,n", [(2, 8), (4, 1)])
def test_chunked_batched_and_other_state_sizes(bsz, n):
    arrs = _inputs((bsz, 45, 48, n), seed=7)
    y, hf = ssm_scan_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                                 *tops.chunk_plan(bsz, 45, 48, n_chunks=4))
    yr, hr = jssm_ref(*(jnp.asarray(a) for a in arrs))
    assert_f32_close(to_np(y), yr)
    assert_f32_close(to_np(hf), hr)


def test_dropped_carry_is_visible():
    """Scanning the second chunk from 0 instead of its carried state moves
    its first outputs by O(1): inputs like these catch a kernel that loses
    the carry, and the chunked version does not lose it."""
    arrs = [torch.from_numpy(a) for a in _inputs((1, 64, 32, 16), seed=3)]
    yr, _ = ssm_scan_ref(*arrs)
    tail = [t[:, 32:] for t in arrs[:2]] + [arrs[2]] + \
        [t[:, 32:] for t in arrs[3:5]] + [torch.zeros_like(arrs[5])]
    y_lost, _ = ssm_scan_ref(*tail)
    assert (y_lost - yr[:, 32:]).abs().max() > 1.0
    y2, _ = ssm_scan_chunked_ref(*arrs, 32, 2)
    assert_f32_close(to_np(y2), to_np(yr))


def test_chunked_rejects_bad_plan():
    arrs = [torch.from_numpy(a) for a in _inputs((1, 10, 8, 4))]
    for plan in ((5, 3), (3, 3), (0, 11)):
        with pytest.raises(ValueError, match="plan"):
            ssm_scan_chunked_ref(*arrs, *plan)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("bsz,di", [(1, 3200), (4, 3200), (1, 200), (2, 37)])
def test_chunk_plan_covers_exactly(bsz, di, sms):
    for s in list(range(1, 130)) + [255, 256, 257, 300, 1000, 2048, 4096]:
        for want in (None, 1, 2, 3, 7, 64, s, s + 5):
            chunk_len, n_chunks = tops.chunk_plan(bsz, s, di, sms, want)
            assert 1 <= n_chunks <= s and chunk_len >= 1
            # every chunk but the last is full, the last is non-empty
            assert chunk_len * (n_chunks - 1) < s <= chunk_len * n_chunks
            if want is not None:
                assert n_chunks <= max(1, min(want, s))


def test_chunk_plan_defaults():
    """Decode and short prompts keep one chunk; hymba's prefill is cut to
    fill the card; a batch of 4 needs fewer chunks."""
    assert tops.chunk_plan(4, 1, 3200) == (1, 1)
    assert tops.chunk_plan(1, 1, 3200) == (1, 1)
    assert tops.chunk_plan(1, tops.MIN_CHUNK_STEPS * 2 - 1, 3200)[1] == 1
    assert tops.chunk_plan(1, 300, 3200) == (17, 18)
    assert tops.chunk_plan(1, 2048, 3200) == (94, 22)
    assert tops.chunk_plan(4, 300, 3200)[1] < tops.chunk_plan(1, 300, 3200)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 300, 3200, 16), (1, 37, 3200, 16),
                                   (4, 300, 3200, 16), (1, 2048, 200, 16),
                                   (2, 129, 256, 8)])
def test_multichunk_kernel_matches_plain_on_card(shape):
    dev = cuda_device()
    args = [torch.from_numpy(a).to(dev) for a in _inputs(shape, seed=9)]
    bsz, s, di, _ = shape
    assert tops.chunk_plan(bsz, s, di, torch.cuda.get_device_properties(
        dev).multi_processor_count)[1] > 1
    y, hf = tops.ssm_scan(*args)
    yp, hp = tops.ssm_scan_plain(*args)
    torch.cuda.synchronize()
    assert_f32_close(to_np(y), to_np(yp))
    assert_f32_close(to_np(hf), to_np(hp))
