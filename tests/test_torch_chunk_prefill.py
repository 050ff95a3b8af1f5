"""Port parity for chunked prefill on gemma3-1b smoke
(``transformer_prefill_chunk``, ``Model.prefill_chunk``).

JAX parameters from ``model.init(PRNGKey(0))`` reach the port through
``from_jax_params``; tokens and the cache a chunk starts from are numpy.
``repro`` attends a chunk with its XLA flash attention, the port with the
plain masked softmax.  Tolerance: f32 2e-5 (logits and caches of the
4-layer smoke model), as in tests/test_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params

from torch_port_util import jax_params_np, to_np

TOL = dict(rtol=2e-5, atol=2e-5)
S, C = 32, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _tokens(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def _filled_cache(jm, seed):
    """A (layers, 1, S, KVH, hd) numpy cache of random rows: what earlier
    chunks left, including rows past the chunk that must stay masked."""
    spec = jax.eval_shape(lambda: jm.init_cache(1, S))
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in spec.items()}


def _assert_close(tout, jout):
    (tl, tc), (jl, jc) = tout, jout
    np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]), **TOL)


@pytest.mark.parametrize("offset,last", [
    (0, 5),          # the chunk that holds the last real token
    (8, 15),         # the chunk's own last position
    (16, 30),        # a later chunk: logits clipped to its last row
    (24, 26),
    (8, 3),          # last_pos before the chunk: clipped to its first row
])
def test_prefill_chunk_matches_jax(models, offset, last):
    jcfg, jm, jp, _, tm, tp = models
    toks = _tokens(offset, C, jcfg.vocab_size)
    cache = _filled_cache(jm, seed=offset + 100)
    jout = jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)},
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.int32(offset),
                            last_pos=jnp.asarray([last], jnp.int32))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks).long()},
                            tcache, offset, last_pos=np.asarray([last]))
    assert tout[1] is tcache            # the cache is written in place
    assert tuple(tout[0].shape) == (1, 1, jcfg.vocab_size)
    _assert_close(tout, jout)


def test_prefill_chunk_without_last_pos(models):
    jcfg, jm, jp, _, tm, tp = models
    toks = _tokens(7, C, jcfg.vocab_size)
    cache = _filled_cache(jm, seed=7)
    jout = jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)},
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.int32(16))
    tout = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks).long()},
                            {k: torch.from_numpy(v.copy())
                             for k, v in cache.items()}, 16)
    _assert_close(tout, jout)


@pytest.mark.parametrize("n_real", [32, 27])
def test_chained_chunks_match_whole_prefill(models, n_real):
    """Chunks at offsets 0, 8, 16, 24 give the whole prefill's last-token
    logits and cache, in the port and against repro's chained chunks;
    ``n_real`` < 32 is a right-padded prompt, whose logits come from the
    chunk that holds position n_real - 1."""
    jcfg, jm, jp, _, tm, tp = models
    toks = _tokens(3, S, jcfg.vocab_size)
    toks[:, n_real:] = 0
    last = np.asarray([n_real - 1])
    tt = torch.from_numpy(toks).long()
    tw = tm.prefill(tp, {"tokens": tt}, tm.init_cache(1, S), last_pos=last)
    tc = tm.init_cache(1, S)
    jc = jm.init_cache(1, S)
    for off in range(0, S, C):
        tl, tc = tm.prefill_chunk(tp, {"tokens": tt[:, off:off + C]}, tc,
                                  off, last_pos=last)
        jl, jc = jm.prefill_chunk(jp, {"tokens": jnp.asarray(
            toks[:, off:off + C])}, jc, jnp.int32(off),
            last_pos=jnp.asarray(last, jnp.int32))
    _assert_close((tl, tc), (jl, jc))
    _assert_close((tl, tc), tw)
    assert int(tl[0, -1].argmax()) == int(tw[0][0, -1].argmax())


def test_hybrid_has_no_chunked_prefill():
    assert tbuild(tget("hymba-1.5b", smoke=True), device="cpu") \
        .prefill_chunk is None
