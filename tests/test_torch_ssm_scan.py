"""Port parity for the SSM selective scan (``kernels/ssm_scan``).

The port's ``ssm_scan`` (its plain version on these CPU tensors) is held
against repro's ``ssm_scan_ref`` and against the Pallas kernel in
interpret mode, on inputs made with numpy.  Tolerance: f32 outputs and
every h_final within 2e-5 * max(1, |ref|); bf16 outputs within one bf16
ulp of the output plus that f32 limit (both sides round to bf16 an f32
value that agrees to the f32 limit; where y cancels to near 0 the f32
difference alone can span a bf16 ulp of so small a value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as jssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jssm_ref
from repro.layers.mamba import ssm_scan_chunked as jchunked

from repro_torch.kernels.ssm_scan import ops as tops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref as tssm_ref
from repro_torch.layers.mamba import ssm_scan_chunked as tchunked

from torch_port_util import cuda_device, to_np

F32_TOL = 2e-5
SHAPES = [(1, 64, 32, 8), (2, 100, 96, 16), (1, 128, 256, 4), (2, 1, 48, 16)]


def _inputs(shape, seed=0):
    """numpy (dt, x, a, b, c, h0) like tests/test_kernels.py's sweep, with
    a nonzero h0."""
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


def _to(arrs, lib, dtype):
    """dt, x, b, c in ``dtype``; a and h0 stay float32."""
    out = []
    for i, arr in enumerate(arrs):
        low = i in (0, 1, 3, 4)
        if lib == "jax":
            out.append(jnp.asarray(arr, dtype if low else jnp.float32))
        else:
            t = torch.from_numpy(arr.copy())
            out.append(t.to(dtype) if low else t)
    return out


def assert_f32_close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    lim = tol * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"max err {err.max()} (limit {lim.max()})"


def assert_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp at the larger magnitude (8 bits of
    mantissa: ulp = 2^(e - 7) for |v| in [2^e, 2^(e+1))) plus the f32
    limit."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    lim = ulp + F32_TOL * np.maximum(1.0, np.abs(want))
    err = np.abs(got - want)
    assert (err <= lim).all(), f"max err {err.max()} in ulps " \
        f"{(err / ulp).max()}"


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_ref_f32(shape):
    arrs = _inputs(shape)
    y, hf = tops.ssm_scan(*_to(arrs, "torch", torch.float32), chunk=32)
    yr, hr = jssm_ref(*_to(arrs, "jax", jnp.float32))
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    assert_f32_close(to_np(y), yr)
    assert_f32_close(to_np(hf), hr)
    # outputs of magnitude O(1): a dropped step or h0 moves them by O(1)
    assert np.abs(np.asarray(yr)).max() > 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, dtype):
    arrs = _inputs(shape, seed=1)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    y, hf = tops.ssm_scan(*_to(arrs, "torch", tdt), chunk=32,
                          channel_block=32)
    yj, hj = jssm_scan(*_to(arrs, "jax", jdt), chunk=32, channel_block=32,
                       interpret=True)
    assert y.dtype == tdt and tuple(y.shape) == tuple(yj.shape)
    if dtype == "float32":
        assert_f32_close(to_np(y), yj)
    else:
        assert_bf16_ulp(to_np(y), yj)
    assert_f32_close(to_np(hf), hj)


def test_h0_defaults_to_zeros():
    dt, x, a, b, c, _ = _to(_inputs((1, 20, 16, 8)), "torch", torch.float32)
    y0, h0f = tops.ssm_scan(dt, x, a, b, c)
    y1, h1f = tops.ssm_scan(dt, x, a, b, c, torch.zeros(1, 16, 8))
    assert torch.equal(y0, y1) and torch.equal(h0f, h1f)


def test_state_carries_across_calls():
    """Scanning S steps at once equals scanning them in two calls with
    h_final handed on as h0: what the decode step relies on."""
    dt, x, a, b, c, h0 = _to(_inputs((2, 30, 24, 16)), "torch",
                             torch.float32)
    y, hf = tops.ssm_scan(dt, x, a, b, c, h0)
    y1, h1 = tops.ssm_scan(dt[:, :29], x[:, :29], a, b[:, :29], c[:, :29], h0)
    y2, h2 = tops.ssm_scan(dt[:, 29:], x[:, 29:], a, b[:, 29:], c[:, 29:], h1)
    assert_f32_close(to_np(torch.cat([y1, y2], 1)), to_np(y))
    assert_f32_close(to_np(h2), to_np(hf))


def test_chunked_matches_jax_chunked():
    """The layer-level ``ssm_scan_chunked`` against repro's associative
    scan, at a length that is no multiple of the chunk."""
    arrs = _inputs((2, 45, 64, 8), seed=2)
    y, hf = tchunked(*_to(arrs, "torch", torch.float32), chunk=16)
    yj, hj = jchunked(*_to(arrs, "jax", jnp.float32), chunk=16)
    assert_f32_close(to_np(y), yj)
    assert_f32_close(to_np(hf), hj)


def test_cpu_call_counts_no_launch(monkeypatch):
    monkeypatch.setattr(tops, "LAUNCHES", 0)
    tops.ssm_scan(*_to(_inputs((1, 4, 8, 4)), "torch", torch.float32))
    assert tops.LAUNCHES == 0


@pytest.mark.parametrize("bad, match", [
    (dict(n=3), "state size"),
    (dict(xdtype=torch.bfloat16), "one dtype"),
    (dict(hdtype=torch.bfloat16), "h0 must be float32"),
    (dict(strided=True), "contiguous"),
    (dict(ashape=(8, 8)), "shape mismatch"),
])
def test_kernel_argument_checks(bad, match):
    """The checks the wrapper makes before it launches the kernel."""
    n = bad.get("n", 4)
    dt, x, a, b, c, h0 = (torch.zeros(s) for s in (
        (1, 5, 16), (1, 5, 16), bad.get("ashape", (16, n)), (1, 5, n),
        (1, 5, n), (1, 16, n)))
    x = x.to(bad.get("xdtype", torch.float32))
    h0 = h0.to(bad.get("hdtype", torch.float32))
    if bad.get("strided"):
        dt = torch.zeros(1, 16, 5).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        tops._check(dt, x, a, b, c, h0)


def test_tensor_on_unknown_device_raises():
    dt, x, a, b, c, h0 = _to(_inputs((1, 3, 8, 4)), "torch", torch.float32)
    with pytest.raises(ValueError, match="device"):
        tops.ssm_scan(dt.to("meta"), x, a, b, c, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 300, 3200, 16), (4, 1, 3200, 16),
                                   (1, 37, 200, 16)])
def test_kernel_matches_plain_on_card(shape):
    dev = cuda_device()
    arrs = _inputs(shape, seed=3)
    args = [t.to(dev) for t in _to(arrs, "torch", torch.float32)]
    y, hf = tops.ssm_scan(*args)
    yp, hp = tops.ssm_scan_plain(*args)
    torch.cuda.synchronize()
    assert_f32_close(to_np(y), to_np(yp))
    assert_f32_close(to_np(hf), to_np(hp))
    yr, _ = tssm_ref(*args)
    assert torch.equal(yp, yr)
