"""Port parity for the dataplane bounce / cost kernel.

The port's plain versions (CPU tensors) are held against repro's Pallas
kernel in interpret mode on the same cases as
tests/test_dataplane_kernels.py.  Tolerance: exact — outputs compared bit
for bit through integer views, counters equal.  The kernel-vs-plain case
needs the card and skips here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dataplane as jdk

from repro_torch.core import techniques as ttech
from repro_torch.kernels import dataplane as tdk

from torch_port_util import bits, cuda_device, pin_calibration

BOUNCE_CASES = [
    # (shape, dtype, copies, chunk_elems) — tests/test_dataplane_kernels.py
    ((37,), "float32", 1, 16),
    ((64, 16), "uint8", 3, 256),
    ((8193,), "float32", 2, 8192),
    ((3, 5, 7), "bfloat16", 1, 32),
    ((1,), "float32", 2, 8192),
    ((4096,), "int32", 1, 1024),
]

_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32,
      "uint8": jnp.uint8}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32, "uint8": torch.uint8}


def _pair(shape, dtype, seed=0):
    """The same payload as a JAX array and a CPU tensor."""
    rng = np.random.default_rng(seed)
    if dtype in ("int32", "uint8"):
        a = rng.integers(0, 200, size=shape).astype(dtype)
        return jnp.asarray(a), torch.from_numpy(a.copy())
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(_J[dtype]), torch.from_numpy(a).to(_T[dtype])


@pytest.mark.parametrize("shape,dtype,copies,chunk", BOUNCE_CASES)
def test_bounce_copy_bit_identical_to_jax(shape, dtype, copies, chunk):
    jx, tx = _pair(shape, dtype)
    want = jdk.bounce_copy(jx, copies=copies, chunk_elems=chunk,
                           interpret=True)
    got = tdk.bounce_copy(tx, copies=copies, chunk_elems=chunk)
    assert tuple(got.shape) == shape and got.dtype == tx.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("shape,dtype,copies,chunk", BOUNCE_CASES)
@pytest.mark.parametrize("delay", [0, 7, 50])
def test_mediated_cost_matches_jax(shape, dtype, copies, chunk, delay):
    jx, tx = _pair(shape, dtype, seed=1)
    jout, jctr = jdk.mediated_cost(jx, delay, copies, chunk_elems=chunk,
                                   interpret=True)
    tout, tctr = tdk.mediated_cost(tx, delay, copies, chunk_elems=chunk)
    np.testing.assert_array_equal(bits(tout), bits(jout))
    np.testing.assert_array_equal(tctr.numpy(), np.asarray(jctr))
    assert tctr.dtype == torch.int32


def test_nonfinite_payload_bit_identical():
    a = np.array([np.nan, -0.0, np.inf, -np.inf, 1.5], np.float32)
    jout, jctr = jdk.mediated_cost(jnp.asarray(a), 100, 2, chunk_elems=2,
                                   interpret=True)
    tout, tctr = tdk.mediated_cost(torch.from_numpy(a), 100, 2,
                                   chunk_elems=2)
    np.testing.assert_array_equal(bits(tout), a.view(np.int32))
    np.testing.assert_array_equal(bits(tout), bits(jout))
    np.testing.assert_array_equal(tctr.numpy(), np.asarray(jctr))
    got = tdk.bounce_copy(torch.from_numpy(a), copies=2, chunk_elems=2)
    np.testing.assert_array_equal(bits(got), a.view(np.int32))


def test_kernel_cost_totals_grid_equal():
    for n in (0, 1, 7, 16, 33, 8192, 8193, 20000):
        for delay in (0, 1, 5, 400, 12345):
            for copies in (0, 1, 3):
                for chunk in (1, 16, 8192):
                    assert tdk.kernel_cost_totals(n, delay, copies, chunk) == \
                        jdk.kernel_cost_totals(n, delay, copies, chunk)


def test_shortcuts():
    x = torch.arange(10.0)
    assert tdk.bounce_copy(x, copies=0) is x
    e = torch.zeros((0,))
    assert tdk.bounce_copy(e, copies=2) is e
    out, ctrs = tdk.mediated_cost(x, 0, 0)
    assert out is x
    assert ctrs.shape == (1, 2) and ctrs.dtype == torch.int32
    assert not ctrs.any()
    out, _ = tdk.mediated_cost(e, 10, 1)
    assert out is e


def test_use_pallas_dataplane_resolution():
    assert tdk.use_pallas_dataplane("on") is jdk.use_pallas_dataplane("on")
    assert tdk.use_pallas_dataplane("off") is jdk.use_pallas_dataplane("off")
    assert tdk.use_pallas_dataplane(True) is True
    # "auto" is the kernel path on the card only; JAX's on the TPU only
    assert tdk.use_pallas_dataplane("auto", device="cpu") is False
    assert jdk.use_pallas_dataplane("auto") is False
    assert tdk.use_pallas_dataplane("auto", device="cuda") is True
    with pytest.raises(ValueError):
        tdk.use_pallas_dataplane("maybe")


def test_calibration_one_slope(monkeypatch):
    pin_calibration(monkeypatch, 2.5)
    assert tdk.kernel_calibrate(device="cpu") == \
        ttech.calibrate(device="cpu") == 2.5
    assert tdk.rescale_iters(1234) == jdk.rescale_iters(1234) == 1234
    assert tdk.rescale_iters(0) == 0
    assert tdk.kernel_iters_for_ns(0, device="cpu") == 0
    assert tdk.kernel_iters_for_ns(400, device="cpu") == \
        jdk.kernel_iters_for_ns(400) == 160
    assert ttech.iters_for_ns(400, device="cpu") == 160


def test_host_calibration_memoized():
    ttech._CALIBRATION.pop(("cpu", 1000), None)
    a = ttech.calibrate(1000, device="cpu")
    assert ttech._CALIBRATION[("cpu", 1000)] == a > 0
    assert ttech.calibrate(1000, device="cpu") == a
    ttech._CALIBRATION.pop(("cpu", 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_kernel_matches_plain_on_card(dtype):
    dev = cuda_device()
    _, tx = _pair((8193,), dtype, seed=2)
    x = tx.to(dev)
    for copies, delay in ((0, 5), (1, 0), (3, 100)):
        got, gctr = tdk.mediated_cost(x, delay, copies)
        want, wctr = tdk.mediated_cost_plain(x, delay, copies)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(bits(got), bits(want))
        np.testing.assert_array_equal(gctr.cpu().numpy(), wctr.cpu().numpy())


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_ring_plan_covers_payload(sms):
    """The kernel's tiles (``bounce.ring_plan``, mirroring ``make_plan`` in
    csrc/bounce.cu) are 16-byte multiples of 2-32 KB that cover the
    aligned body exactly, over a grid of at most one block per SM and per
    tile."""
    from repro_torch.kernels.dataplane import bounce as tb
    sizes = [0, 1, 15, 16, 17, 2047, 2048, 2049, 65536, 1 << 20,
             132 * 32768 - 1, 132 * 32768, 132 * 32768 + 1, 1_207_959_552]
    for n in sizes:
        for off in (0, 1, 4, 8, 15):
            tile, n_tiles, grid = tb.ring_plan(n, sms, off)
            head = min((16 - off) % 16, n)
            body = (n - head) // 16 * 16
            assert tile % 16 == 0
            assert tb.RING_TILE_MIN <= tile <= tb.RING_TILE_MAX
            assert (n_tiles - 1) * tile < body <= n_tiles * tile or \
                body == n_tiles == 0
            assert 1 <= grid <= max(1, min(n_tiles, sms))
    # the gemma3-1b f32 table: 32 KB tiles, every SM busy, a ring of more
    # turns than stages
    tile, n_tiles, grid = tb.ring_plan(262_144 * 1152 * 4, 132)
    assert (tile, grid) == (tb.RING_TILE_MAX, 132)
    assert n_tiles > grid * tb.RING_STAGES
    # a 9 KB decode activation wakes a few blocks, not the card
    assert tb.ring_plan(9216, 132)[2] <= 5


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4, 8, 15])
@pytest.mark.parametrize("copies,delay", [(1, 0), (2, 37), (0, 5)])
def test_misaligned_payload_matches_plain_on_card(offset, copies, delay):
    """A view at a storage offset of 1-15 bytes: the unaligned head and
    tail, or (x and out disagreeing modulo 16) the whole payload, take
    the kernel's ordinary path; bits and counters stay exact."""
    dev = cuda_device()
    base = torch.randint(0, 256, (132 * 32768 + 77,), dtype=torch.uint8,
                         device=dev)
    for n in (5, 16 * 7 + 1, 32768 - 1, 132 * 32768 + 1):
        x = base[offset:offset + n]
        got, gctr = tdk.mediated_cost(x, delay, copies)
        want, wctr = tdk.mediated_cost_plain(x, delay, copies)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(bits(got), bits(want))
        np.testing.assert_array_equal(gctr.cpu().numpy(), wctr.cpu().numpy())
        if offset % 4 == 0:
            xf = x[:n // 4 * 4].view(torch.float32)
            gotf, _ = tdk.mediated_cost(xf, delay, copies)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(bits(gotf), bits(xf))
