"""Port parity for the dense transformer on gemma3-1b smoke.

JAX parameters from ``model.init(PRNGKey(0))`` reach the port through
``from_jax_params``; inputs are numpy.  Tolerance: f32 2e-5 (logits and
caches of the 4-layer smoke model), as in tests/test_kernels.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.layers import common as jcommon
from repro.layers import embedding as jemb
from repro.layers.mlp import mlp as jmlp
from repro.layers import rope as jrope
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.layers import common as tcommon
from repro_torch.layers import embedding as temb
from repro_torch.layers.mlp import mlp as tmlp
from repro_torch.layers import rope as trope
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params

from torch_port_util import jax_params_np, to_np

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_params_converted_exactly(models):
    _, _, jp, _, _, tp = models
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_rmsnorm_rope_mlp_embed_match(models):
    jcfg, _, jp, _, _, tp = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(jcfg.d_model).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        to_np(tcommon.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6)),
        to_np(jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        **TOL)

    qh = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 3, 7, 100, 511]] * 2, np.int32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            to_np(trope.apply_rope(_t(qh), _t(pos), theta)),
            to_np(jrope.apply_rope(jnp.asarray(qh), jnp.asarray(pos), theta)),
            **TOL)

    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    lp_t = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    np.testing.assert_allclose(
        to_np(tmlp(lp_t, _t(x), act="gelu")),
        to_np(jmlp(lp_j, jnp.asarray(x), act="gelu")), **TOL)

    toks = np.array([[1, 5, 255, 0]], np.int32)
    np.testing.assert_allclose(
        to_np(temb.embed(tp["embed"], _t(toks).long(), torch.float32)),
        to_np(jemb.embed(jp["embed"], jnp.asarray(toks), jnp.float32)),
        **TOL)
    np.testing.assert_allclose(
        to_np(temb.logits(tp["embed"], _t(x))),
        to_np(jemb.logits(jp["embed"], jnp.asarray(x))), **TOL)


def test_prefill_logits_and_cache_match(models):
    _, jm, jp, _, tm, tp = models
    toks = (np.arange(16, dtype=np.int32)[None] * 7 + 3) % 256
    toks = np.concatenate([toks, toks[:, ::-1]])          # batch 2
    last = np.array([15, 9], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, 16), last_pos=jnp.asarray(last))
    tl_, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(2, 16),
                         last_pos=_t(last))
    assert tuple(tl_.shape) == (2, 1, 256) and tl_.dtype == torch.float32
    np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]), **TOL)


def test_decode_slots_mixed_positions_match(models):
    """A run of fixed-shape slot decode steps over slots at different
    positions matches repro step for step."""
    jcfg, jm, jp, _, tm, tp = models
    B, S = 3, 24
    rng = np.random.default_rng(1)
    kc = rng.standard_normal((jcfg.num_layers, B, S, 1, 16)).astype(np.float32)
    vc = rng.standard_normal((jcfg.num_layers, B, S, 1, 16)).astype(np.float32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    tcache = {"k": _t(kc), "v": _t(vc)}
    pos = np.array([2, 9, 15], np.int32)
    tok = np.array([[5], [77], [200]], np.int32)
    step = jax.jit(jm.decode_step_slots)
    for _ in range(4):
        jl, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl_, tcache = tm.decode_step_slots(tp, _t(tok).long(), tcache,
                                           _t(pos))
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tcache[name]), to_np(jcache[name]),
                                   **TOL)


def test_gang_decode_step_matches(models):
    _, jm, jp, _, tm, tp = models
    toks = (np.arange(12, dtype=np.int32)[None] * 5 + 1) % 256
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(1, 20))
    tl_, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(1, 20))
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, 12 + i)
        tl_, tc = tm.decode_step(tp, _t(tok).long(), tc, 12 + i)
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_other_families_wait():
    """Every family ``repro`` builds is built (the ssm and encdec families
    waited for a later slice), with ``repro``'s serving flags; an unknown
    family raises as ``repro``'s."""
    from repro.configs import get_model_config as jcfg_of

    for arch in ("gemma3-1b", "grok-1-314b", "llava-next-34b", "hymba-1.5b",
                 "xlstm-350m", "whisper-small"):
        jm = jbuild(jcfg_of(arch, smoke=True))
        tm = tbuild(tget(arch, smoke=True), device="cpu")
        assert tm.recurrent == jm.recurrent, arch
        assert (tm.prefill_chunk is None) == (jm.prefill_chunk is None), arch
        assert tm.decode_step_slots is not None, arch
    cfg = tget("gemma3-1b", smoke=True)
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(dataclasses.replace(cfg, family="rnn"), device="cpu")


def test_forward_constants_are_made_once_per_device():
    """RoPE's frequencies and the embedding scale are made once per
    device (and dtype) and reused, never uploaded again by a forward;
    the cached values are bit for bit those made afresh."""
    for theta in (10_000.0, 1_000_000.0):
        f = trope.rope_freqs(16, theta)
        assert trope.rope_freqs(16, theta) is f
        assert torch.equal(f, trope._rope_freqs.__wrapped__(
            16, theta, torch.device("cpu")))
    for dtype in (torch.float32, torch.bfloat16):
        sc = temb._embed_scale(1152, dtype, torch.device("cpu"))
        assert temb._embed_scale(1152, dtype, torch.device("cpu")) is sc
        assert sc.dtype == dtype and float(sc) == float(
            torch.tensor(1152 ** 0.5, dtype=dtype))
    with torch.inference_mode():
        trope._rope_freqs.cache_clear()
        f = trope.rope_freqs(16, 123.0)
    assert not f.is_inference()      # usable under autograd later
