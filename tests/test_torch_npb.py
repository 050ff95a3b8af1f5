"""Port parity for the NPB suite (``repro_torch.bench.npb``, the paper's
Fig. 6) and its demo against ``benchmarks/npb.py`` on the 8-device
``("rank",)`` mesh, at reduced sizes, the same on both sides.

Tolerances:
- every counter column exact in every mode: the trace-time telemetry
  (``comm_ops``, ``comm_mib``'s bytes: one trace of ``repro``'s jitted
  body, however often it runs) and the runtime state of one call
  (``rt_ops``, ``rt_mib``'s bytes: every executed op);
- EP and IS exact given the same draws (JAX's, handed to the port's
  ``draw``): EP counts points as integers in float32 below 2^24, IS
  returns its last draw;
- MG at float32 2e-5 (rtol and atol): only adds and scalings, which XLA
  may contract or reorder;
- CG at 1e-5 relative to its largest entry: 4 iterations of dots of 256
  terms a rank summed in another order than XLA's, each feeding the next
  step's alpha and beta (1.2e-7 seen);
- FT at 1e-5 relative to its largest entry: pocketfft here against XLA's
  FFT on the CPU, three unnormalised column transforms (magnitudes grow
  by sqrt(n) a step), each rounding at log2(n) levels (2.3e-7 seen);
- the port's outputs bit-identical across bypass, cord and socket:
  mediation changes cost, never results (the porting contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import npb as jnpb

from repro_torch.bench import npb as tnpb
from repro_torch.examples import npb_demo

from torch_port_util import bits

MODES = ("bypass", "cord", "socket")
MG_TOL = dict(rtol=2e-5, atol=2e-5)
CG_REL = 1e-5
FT_REL = 1e-5
R = 8


def _ep_draw(rank, step, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(0), rank * 1000 + step)
    return np.array(jax.random.uniform(key, shape))


def _is_draw(rank, step, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(1), rank * 77 + step)
    return np.array(jax.random.randint(key, shape, 0, 2**20, jnp.int32))


# name: (sizes, the input, the port's extra ``build_*`` arguments)
CASES = {
    "EP": (dict(n_per_rank=1 << 10, steps=2), lambda: jnp.zeros(()),
           dict(draw=_ep_draw)),
    "IS": (dict(n_per_rank=1 << 8, steps=3),
           lambda: jax.random.randint(jax.random.PRNGKey(3), (R, 1 << 8), 0,
                                      2**20, jnp.int32),
           dict(draw=_is_draw)),
    "CG": (dict(n_per_rank=1 << 8, iters=4),
           lambda: jax.random.normal(jax.random.PRNGKey(4), (R, 1 << 8)),
           {}),
    "FT": (dict(n=64, steps=2),
           lambda: jax.random.normal(jax.random.PRNGKey(5), (64, 64)), {}),
    "MG": (dict(n_per_rank=1 << 6, cycles=2),
           lambda: jax.random.normal(jax.random.PRNGKey(6), (R, 1 << 6)),
           {}),
}


def _counters(dp, rt):
    comm = dp.telemetry.by_kind()
    runtime = dp.runtime_report(rt)[dp.tenant]
    return {"comm_ops": int(sum(v["ops"] for v in comm.values())),
            "comm_bytes": int(sum(v["bytes"] for v in comm.values())),
            "rt_ops": float(runtime["ops"]),
            "rt_bytes": float(runtime["bytes"])}


def _run_jax(name, mode):
    sizes, arg_fn, _ = CASES[name]
    mesh = jnpb.make_mesh()
    dp = jnpb.make_dp(mode, mesh)
    fn = getattr(jnpb, f"build_{name.lower()}")(mesh, dp, **sizes)
    arg = arg_fn()
    out, rt = jax.block_until_ready(fn(arg, dp.runtime_init()))
    jax.block_until_ready(fn(arg, dp.runtime_init()))   # a cached call
    return np.asarray(out), _counters(dp, rt), np.asarray(arg)


def _run_port(name, mode, arg):
    sizes, _, extra = CASES[name]
    mesh = tnpb.make_mesh()
    dp = tnpb.make_dp(mode, mesh, device="cpu")
    fn = getattr(tnpb, f"build_{name.lower()}")(mesh, dp, **sizes, **extra)
    x = torch.from_numpy(np.array(arg))
    out, rt = fn(x, dp.runtime_init())
    first = _counters(dp, rt)
    out2, rt2 = fn(x, dp.runtime_init())     # records nothing more
    assert _counters(dp, rt2) == first
    assert np.array_equal(bits(out2), bits(out))
    return out, first


@pytest.fixture(scope="module")
def jax_runs():
    return {(name, mode): _run_jax(name, mode)
            for name in CASES for mode in MODES}


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    return {key: _run_port(*key, jax_runs[key][2]) for key in jax_runs}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_counters_exact(jax_runs, port_runs, name, mode):
    assert port_runs[(name, mode)][1] == jax_runs[(name, mode)][1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_results_match(jax_runs, port_runs, name, mode):
    want = jax_runs[(name, mode)][0]
    got = port_runs[(name, mode)][0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1.0)
    if name in ("EP", "IS"):
        np.testing.assert_array_equal(got, want)
    elif name == "MG":
        np.testing.assert_allclose(got, want, **MG_TOL)
    else:
        rel = CG_REL if name == "CG" else FT_REL
        assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("name", list(CASES))
def test_modes_bit_identical(port_runs, name):
    ref = bits(port_runs[(name, "bypass")][0])
    for mode in MODES[1:]:
        assert np.array_equal(bits(port_runs[(name, mode)][0]), ref), mode


def test_generator_draws_are_seeded():
    """Without a ``draw``, EP and IS draw from generators seeded by the
    ``build_*`` function's seed, the rank and the step: two dataplanes,
    one answer."""
    outs = []
    for _ in range(2):
        dp = tnpb.make_dp("cord", tnpb.make_mesh(), device="cpu")
        fn = tnpb.build_is(tnpb.make_mesh(), dp, n_per_rank=64, steps=2)
        keys = torch.zeros((R, 64), dtype=torch.int32)
        outs.append(fn(keys, dp.runtime_init())[0])
    assert torch.equal(outs[0], outs[1])
    assert outs[0].min() >= 0 and outs[0].max() < 2**20
    assert len({tuple(row.tolist()) for row in outs[0]}) == R


# executed ops a call at ``repro``'s sizes, in cord and socket mode: EP's
# one psum, CG's psum and 12 iterations of 2 halos and 2 psums, FT's 3
# steps of 2 transposes
RT_OPS = {"EP": 1, "CG": 1 + 12 * 4, "FT": 3 * 2}


def test_demo_rows(jax_runs, capsys):
    """The demo's rows at ``repro``'s sizes: EP, CG and FT in each mode,
    the trace-time op counts as ``repro``'s (one trace, whatever the
    sizes), the executed ops of one call, the first mode the base of
    ``rel_runtime``, the table printed."""
    rows = npb_demo.main(["--device", "cpu"])
    assert [(r["bench"], r["mode"]) for r in rows] == \
        [(b, m) for b in ("EP", "CG", "FT") for m in MODES]
    for r in rows:
        want = jax_runs[(r["bench"], r["mode"])][1]
        assert r["comm_ops"] == want["comm_ops"]
        assert r["rt_ops"] == (0 if r["mode"] == "bypass"
                               else RT_OPS[r["bench"]])
        if r["mode"] == "bypass":
            assert r["rel_runtime"] == 1.0
    out = capsys.readouterr().out
    assert "paper claim" in out and out.count("socket") >= 3


def test_run_all_outputs_identical_across_modes():
    """``run_all``'s outputs at ``repro``'s sizes (IS and MG here; the
    demo runs the rest) are the same bits in every mode."""
    outs = {}
    rows = tnpb.run_all(benches=("IS", "MG"), device="cpu", outputs=outs)
    assert len(rows) == 6 and len(outs) == 6
    for name in ("IS", "MG"):
        ref = bits(outs[(name, "bypass")])
        for mode in MODES[1:]:
            assert np.array_equal(bits(outs[(name, mode)]), ref)
