"""The f32 flash kernels on the card: the forward
(``flash_fwd_f32_kernel``) and the backward (``flash_bwd_dkdv_f32``,
``flash_bwd_dq_f32``) of ``kernels/flash_attention/csrc/
flash_attention.cu``, which run every product on the tensor cores as
three TF32 products for each f32 one.

Each is held against its plain version on the card at every f32 head
dim (16, 32, 64, 128, 256) and at the masks the kernels take: GQA 2:1
and 4:1, a window on and off the 64-row tile grid, ``valid_len`` inside a
tile and 0 (the forward; every row 0), a tanh soft cap, non-causal Sq !=
Skv, one query and a ragged S.  Tolerances are the f32 gates of
``chip_smoke.py``: the output within 2e-5 and the lse within 2e-5 x
max(1, |lse|) of the plain forward; each gradient within 2e-5 x max(1,
|ref|) of the plain backward's formula (``ref.flash_attention_bwd_plain``)
evaluated in float64 from the same o and lse, since the plain version's
own float32 sums are up to a whole gate from it at D = 256 with these
inputs (``tools/flash_f32_precision.py``'s mirror, PERF.md); two backward
calls give the same bits.  Inputs are made with numpy from a seed: q = 3
N(0, 1), k and do N(0, 1), v uniform in [-1.5, 1.5).  Every test needs
the card (``tools/card_tests.py`` runs them there)."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops

from torch_port_util import cuda_device

TOL = 2e-5


@pytest.fixture(autouse=True)
def _plain_in_f32():
    """The plain versions' products in full f32 on the card, not TF32."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = keep


# label: (B, Sq, Skv, H, KVH, causal, window, valid_len, logit_cap)
CASES = {"gqa2": (2, 200, 200, 4, 2, True, 0, None, 0.0),
         "gqa4-window-on-grid": (1, 200, 200, 8, 2, True, 64, None, 0.0),
         "window-off-grid": (1, 200, 200, 4, 1, True, 37, None, 0.0),
         "valid-len-in-tile": (1, 200, 200, 4, 2, True, 0, 70, 0.0),
         "valid-len-0": (1, 130, 130, 4, 1, True, 0, 0, 0.0),
         "cap": (1, 150, 150, 6, 2, True, 0, None, 30.0),
         "noncausal-cross": (2, 70, 333, 6, 3, False, 0, None, 0.0),
         "one-query": (1, 1, 1, 4, 2, True, 0, None, 0.0),
         "ragged": (1, 77, 77, 4, 4, True, 0, None, 0.0)}
# the backward takes no valid_len: every key below Skv is valid
BWD_CASES = {k: c for k, c in CASES.items() if c[7] is None}


def _inputs(case, d: int, seed: int):
    b, sq, skv, h, kvh = case[:5]
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (3 * rng.standard_normal((b, sq, h, d)),
            rng.standard_normal((b, skv, kvh, d)),
            rng.random((b, skv, kvh, d)) * 3 - 1.5,
            rng.standard_normal((b, sq, h, d)))
    dev = cuda_device()
    return tuple(torch.from_numpy(a.astype(f)).to(dev) for a in arrs)


def _kw(case):
    _, _, _, _, _, causal, window, valid, cap = case
    return dict(causal=causal, window=window, valid_len=valid,
                logit_cap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
@pytest.mark.parametrize("label", list(CASES))
def test_forward_matches_plain_on_card(label, d):
    case = CASES[label]
    q, k, v, _ = _inputs(case, d, seed=d + len(label))
    kw = _kw(case)
    if case[7] == 0:   # no key: every row 0, and no lse to give
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert not got.any()
        return
    n0 = (ops.LAUNCHES, ops.LSE_LAUNCHES)
    got, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    want, plse = ops.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES - n0[0], ops.LSE_LAUNCHES - n0[1]) == (1, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= TOL, f"output error {err}"
    lerr = (lse - plse).abs()
    assert bool((lerr <= TOL * plse.abs().clamp(min=1.0)).all()), \
        f"lse error {lerr.max().item()}"
    # without the lse: the same output
    alone = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(alone, got)


def _bwd_f64(q, k, v, o, lse, do, *, causal, window, logit_cap):
    """(dq, dk, dv) float64: the plain backward's formula, dense, from
    the forward's o and lse (B, KVH, G, Sq)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qh, oh, doh = (t.double().transpose(1, 2) for t in (q, o, do))
    kh, vh = (t.double().transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (k, v))
    raw = qh @ kh.transpose(-1, -2)
    x, dcap = raw * scale, 1.0
    if logit_cap > 0:
        th = torch.tanh(raw * scale / logit_cap)
        x, dcap = logit_cap * th, 1.0 - th * th
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    p = torch.exp(x - lse.reshape(b, h, sq, 1).double()) * mask
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (doh @ vh.transpose(-1, -2) - delta) * dcap
    dq = (ds @ kh * scale).transpose(1, 2)
    dk = (ds.transpose(-1, -2) @ qh * scale).reshape(b, kvh, g, skv, d)
    dv = (p.transpose(-1, -2) @ doh).reshape(b, kvh, g, skv, d)
    return dq, dk.sum(2).transpose(1, 2), dv.sum(2).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
@pytest.mark.parametrize("label", list(BWD_CASES))
def test_backward_matches_plain_on_card(label, d):
    case = BWD_CASES[label]
    q, k, v, do = _inputs(case, d, seed=2 * d + len(label))
    causal, window, cap = case[5], case[6], case[8]
    kw = dict(causal=causal, window=window, logit_cap=cap)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    n0 = ops.BWD_LAUNCHES
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = _bwd_f64(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES - n0 == 2
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), g2.view(torch.int32)), name
        err = (g.double() - w).abs()
        assert bool((err <= TOL * w.abs().clamp(min=1.0)).all()), \
            f"{name}: max err {err.max().item()}"
