"""Port parity for ``WireFault``, the verbs transport's wire plane.

``repro``'s predicates hash ``(wr, attempt, seed)`` in uint32; the port's
do it in int64 (or Python ints) masked to 32 bits.  Tolerance: exact —
every drop and corrupt decision over a (wr, attempt, seed) grid, for
Python ints and int64 tensors alike, explicit schedules included."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.fault import WireFault as JWireFault

from repro_torch.runtime import WireFault as TWireFault

ROOT = pathlib.Path(__file__).resolve().parents[1]
WR, ATT = np.meshgrid(np.arange(160), np.arange(9), indexing="ij")
SCHEDULE = ((5, 0), (7, 2), (150, 8))


def _jax(f, which):
    fn = getattr(f, which)
    return np.asarray(fn(jnp.asarray(WR, jnp.int32),
                         jnp.asarray(ATT, jnp.int32)))


@pytest.mark.parametrize("seed", [0, 3, 9, 12345, 2**31 - 1])
@pytest.mark.parametrize("rates", [(0.1, 0.05), (0.5, 0.5), (1.0, 0.0),
                                   (0.0, 0.0), (0.3, 1.0)])
@pytest.mark.parametrize("sched", [False, True])
def test_predicates_equal_repro_over_grid(seed, rates, sched):
    kw = dict(drop_rate=rates[0], corrupt_rate=rates[1], seed=seed)
    if sched:
        kw.update(drops=SCHEDULE, corrupts=SCHEDULE[1:])
    j, t = JWireFault(**kw), TWireFault(**kw)
    assert t.active == j.active
    wr, att = torch.from_numpy(WR).long(), torch.from_numpy(ATT).long()
    for which in ("drops_wr", "corrupts_wr"):
        want = _jax(j, which)
        got = getattr(t, which)(wr, att)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=which)
        # the transport's host loop calls with Python ints
        ints = np.array([[bool(getattr(t, which)(int(w), int(a)))
                          for a in range(ATT.shape[1])]
                         for w in range(WR.shape[0])])
        np.testing.assert_array_equal(ints, want, err_msg=which)


def test_rates_are_validated():
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            TWireFault(drop_rate=bad)
        with pytest.raises(ValueError):
            TWireFault(corrupt_rate=bad)
    assert not TWireFault().active
    assert TWireFault(drops=((99, 99),)).active


def test_chip_smoke_golden_schedule_is_repros():
    """``chip_smoke.py`` holds the port's hash against a schedule of
    ``repro``'s (the card has no JAX): it must be ``repro``'s."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    j = JWireFault(**cs.LOSSY)
    n, a = cs.GOLDEN_GRID
    w, t = np.meshgrid(np.arange(n), np.arange(a), indexing="ij")
    for which, golden in (("drops_wr", cs.GOLDEN_DROPS),
                          ("corrupts_wr", cs.GOLDEN_CORRUPTS)):
        hit = np.asarray(getattr(j, which)(jnp.asarray(w), jnp.asarray(t)))
        assert tuple(int(k) for k in np.flatnonzero(hit.ravel())) == golden
