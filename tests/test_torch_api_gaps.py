"""The port's last small API gaps against ``repro``: ``chunked_psum``'s
``interleave`` hook, ``cache_positions`` / ``cache_validity``, and the
train launcher's ``model.*`` overrides.

Tolerance: exact.  ``interleave`` is called with each chunk's index
before that chunk is issued, in ``repro``'s order (its calls happen while
the ``shard_map`` body is traced, the port's while the chunks run); the
cache helpers give ``repro``'s values and dtypes; a ``model.*`` override
is ignored, as ``repro``'s launcher ignores it, so the run's loss equals
the loss without it."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core.chunking import chunked_psum as jchunked
from repro.core.dataplane import Dataplane as JDataplane
from repro.layers import cache_positions as jpositions
from repro.layers import cache_validity as jvalidity

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.chunking import chunked_psum
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers import cache_positions, cache_validity


def _logged(dp, log):
    """``dp`` with every psum's tag appended to ``log`` as it is issued."""
    psum = dp.psum

    def logged(x, axis, tag="psum", **kw):
        log.append(("psum", tag))
        return psum(x, axis, tag, **kw)

    dp.psum = logged
    return dp


@pytest.mark.parametrize("num_chunks", [1, 3])
def test_interleave_runs_before_each_chunk(mesh8, num_chunks):
    x = np.random.default_rng(0).standard_normal((8 * 6, 4)).astype(
        np.float32)
    jlog, tlog = [], []
    jdp = _logged(JDataplane(JCfg(mode="cord"), mesh=mesh8), jlog)
    tdp = _logged(TDataplane(TCfg(mode="cord"),
                             mesh=make_mesh((8,), ("data",)), device="cpu"),
                  tlog)

    @partial(compat.shard_map, mesh=mesh8, in_specs=JP("data"),
             out_specs=JP("data"))
    def f(v):
        return jchunked(jdp, v, "data", num_chunks=num_chunks,
                        interleave=lambda i: jlog.append(("interleave", i))
                        )[0]

    jout = jax.jit(f)(jnp.asarray(x))
    tout, _ = chunked_psum(tdp, torch.from_numpy(x.reshape(8, 6, 4).copy()),
                           "data", num_chunks=num_chunks,
                           interleave=lambda i: tlog.append(("interleave", i)))
    want = []
    for i in range(num_chunks):
        want += [("interleave", i), ("psum", f"chunked_psum/chunk{i}")]
    assert tlog == jlog == want
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout)[:6])


@pytest.mark.parametrize("max_len,filled", [(1, 0), (8, 0), (8, 5), (16, 16),
                                            (5, 9)])
def test_cache_positions_and_validity_match(max_len, filled):
    pos = cache_positions(max_len, "cpu")
    valid = cache_validity(max_len, filled, "cpu")
    assert pos.dtype == torch.int32 and valid.dtype == torch.bool
    assert pos.device.type == valid.device.type == "cpu"
    jp, jv = jpositions(max_len), jvalidity(max_len, filled)
    assert str(jp.dtype) == "int32" and str(jv.dtype) == "bool"
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    # a tensor length, as a traced length in repro
    np.testing.assert_array_equal(
        cache_validity(max_len, torch.tensor(filled), "cpu").numpy(),
        np.asarray(jvalidity(max_len, jnp.int32(filled))))


def test_model_override_is_ignored_and_the_run_goes_on():
    base = ["--device", "cpu", "steps=1", "seq_len=16", "global_batch=2"]
    _, plain = launch_train.main(base)
    _, over = launch_train.main(base + ["model.num_layers=2",
                                        "model.d_model=8"])
    assert over.steps_run == plain.steps_run == 1
    assert over.metrics[0]["loss"] == plain.metrics[0]["loss"]
