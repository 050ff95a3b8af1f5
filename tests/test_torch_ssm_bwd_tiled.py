"""The scan backward kernel's algorithm in plain torch,
``kernels/ssm_scan/ref.ssm_scan_bwd_tiled_ref``, and its float64
exponential ``ref.exp_f64``.

The mirror walks each chain in tiles of ``ref.BWD_TILE`` steps: a forward
sweep keeps the state at every tile start, then each tile is rescanned
from its start and the cotangent walks back through it, with the table
exponential of the kernel.  It is held against the plain gradient
``ref.ssm_scan_bwd_plain`` and against ``jax.grad`` of ``repro``'s
``ssm_scan_chunked`` on the CPU: at small widths across the tile's edges,
and at a long-memory case (S 256, di 64, N 16, dt log-uniform in
[1e-3, 1e-1] and A = -(1..N) as in ``chip_smoke.py``'s phase 2b), where
``jax.grad`` runs in float64.  Inputs are made with numpy from a seed.

Tolerance: each gradient in float32 within 2e-5 * max(1, |ref|), the
gate of the kernel on the card.  The exponential is within 4.1e-11 of
``torch.exp``, relative, where it does not fall back to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.mamba import ssm_scan_chunked as jchunked

from repro_torch.kernels.ssm_scan import ref as sref

from torch_port_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 2e-5
NAMES = ("dt", "x", "a", "b", "c", "h0")
# (B, S, di, N): one step, one tile, one past it, two tiles and one past,
# several with a ragged last one; state sizes 1 to 32
SHAPES = [(1, 1, 8, 4), (1, 8, 6, 16), (2, 9, 8, 2), (1, 17, 12, 8),
          (2, 20, 6, 1), (1, 33, 5, 32), (3, 26, 7, 16)]


def _inputs(shape, seed, long_memory=False):
    bsz, s, di, n = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    if long_memory:
        dt = np.exp(np.log(1e-3) + rng.random((bsz, s, di)) * np.log(100.0))
        a = -np.broadcast_to(np.arange(1, n + 1, dtype=f), (di, n)).copy()
    else:
        dt = 0.3 * np.log1p(np.exp(rng.standard_normal((bsz, s, di))))
        a = -np.exp(rng.standard_normal((di, n)) * 0.3)
    arrs = (dt.astype(f), rng.standard_normal((bsz, s, di)).astype(f),
            a.astype(f), rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, di, n)).astype(f))
    cot = (rng.standard_normal((bsz, s, di)).astype(f),
           rng.standard_normal((bsz, di, n)).astype(f))
    return arrs, cot


def _t(arrs):
    return [None if a is None else torch.from_numpy(a.copy()) for a in arrs]


def _assert_close(got, want, name):
    got = np.asarray(got, np.float32).astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    lim = TOL * np.maximum(1.0, np.abs(want))
    assert (err <= lim).all(), f"{name}: max err {err.max()}"


def _jax_grad(arrs, gy, ghf, dtype):
    """jax.grad of repro's chunked scan, in ``dtype``."""
    gyj = jnp.asarray(gy, dtype)
    ghfj = jnp.asarray(ghf, dtype)

    def loss(*args):
        y, hf = jchunked(*args, chunk=16)
        return (y * gyj).sum() + (hf * ghfj).sum()
    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(t, dtype) for t in arrs))


@pytest.mark.parametrize("which", ["both", "gy", "ghf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_matches_plain(shape, which):
    arrs, (gy, ghf) = _inputs(shape, seed=shape[1])
    cot = _t((None if which == "ghf" else gy, None if which == "gy" else ghf))
    got = sref.ssm_scan_bwd_tiled_ref(*_t(arrs), *cot)
    want = sref.ssm_scan_bwd_plain(*_t(arrs), *cot)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32, name
        _assert_close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_matches_jax_grad(shape):
    arrs, (gy, ghf) = _inputs(shape, seed=shape[1] + 1)
    want = _jax_grad(arrs, gy, ghf, jnp.float32)
    got = sref.ssm_scan_bwd_tiled_ref(*_t(arrs), *_t((gy, ghf)))
    for name, g, j in zip(NAMES, got, want):
        _assert_close(g.numpy(), j, name)


@pytest.mark.parametrize("against", ["plain", "jax_grad_f64"])
def test_tiled_long_memory(against):
    """A state that outlives every tile: S 256, di 64, N 16 with mamba's
    dt and A, the carried state and cotangent crossing 32 tiles."""
    arrs, (gy, ghf) = _inputs((1, 256, 64, 16), seed=0, long_memory=True)
    got = sref.ssm_scan_bwd_tiled_ref(*_t(arrs), *_t((gy, ghf)))
    if against == "plain":
        want = sref.ssm_scan_bwd_plain(*_t(arrs), *_t((gy, ghf)))
    else:
        with jax.enable_x64(True):
            want = _jax_grad(arrs, gy, ghf, jnp.float64)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(g.numpy(), np.asarray(w), name)
    assert max(float(np.abs(np.asarray(w)).max()) for w in want) > 10.0


def test_tiled_takes_bf16_and_keeps_dtypes():
    arrs, (gy, ghf) = _inputs((2, 19, 6, 4), seed=3)
    t = _t(arrs)
    t[0], t[1] = t[0].bfloat16(), t[1].bfloat16()
    g = torch.from_numpy(gy).bfloat16()
    got = sref.ssm_scan_bwd_tiled_ref(*t, g, torch.from_numpy(ghf))
    want = sref.ssm_scan_bwd_plain(*t, g, torch.from_numpy(ghf))
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == w.dtype, name
        lim = TOL * w.float().abs().clamp(min=1.0) + torch.exp2(torch.floor(
            torch.log2(w.float().abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((a.float() - w.float()).abs() <= lim).all()), name


def test_exp_f64_against_torch_exp():
    x = torch.cat([torch.linspace(-745.0, 709.0, 200_001, dtype=torch.float64),
                   torch.linspace(-2.0, 0.5, 100_001, dtype=torch.float64)])
    got, want = sref.exp_f64(x), torch.exp(x)
    inside = x.abs() < 700.0
    rel = ((got - want) / want)[inside].abs().max().item()
    assert rel < 4.1e-11, rel
    assert torch.equal(got[~inside], want[~inside])
    # the far range, infinities and NaN fall back to torch.exp; 0 gives 1
    edge = torch.tensor([float("nan"), float("inf"), -float("inf"), 700.0,
                         -700.0, 0.0, -0.0, 1e-300], dtype=torch.float64)
    got, want = sref.exp_f64(edge), torch.exp(edge)
    assert got[0].isnan()
    assert torch.equal(got[1:5], want[1:5])
    assert (got[5:] == 1.0).all()


@pytest.mark.parametrize("degree", [3, 4, 5])
def test_exp_f64_degree_bounds(degree):
    """The Taylor remainder at |r| <= ln2 / 32 bounds each degree's error:
    9.4e-9, 4.1e-11 and 1.5e-13 (the kernel takes degree 4)."""
    x = torch.linspace(-30.0, 5.0, 300_001, dtype=torch.float64)
    rel = ((sref.exp_f64(x, degree) - torch.exp(x)) / torch.exp(x)).abs()
    assert rel.max().item() < {3: 9.4e-9, 4: 4.1e-11, 5: 1.5e-13}[degree]
