"""Port parity for the encdec family (whisper-small smoke: 2 encoder and
2 decoder layers, 32 frames of 32 mel bins): the encoder, prefill with
and without frames, decode and slot decode, the loss with every
gradient, remat, and non-causal flash attention with a gradient at
Sq != Skv (the cross-attention) against ``repro``'s blocked flash.  JAX
parameters reach the port through ``from_jax_params``; inputs are numpy.

Tolerances: float32 2e-5 (rtol and atol) for hiddens, logits, caches,
losses and gradients, as tests/test_kernels.py holds f32; remat against
none and records exactly.  The ``cuda``-marked test holds the kernel's
non-causal forward and lse at Sq != Skv against its plain version on
the card: bf16 outputs at 1e-2 (chip_smoke.py's bound), lse at 2e-5 x
max(1, |lse|)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core.dataplane import Dataplane as JDataplane
from repro.layers.attention import _flash_fwd_impl, attend_flash
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten
from repro_torch.data import to_torch
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers.attention import attend, prefill_positions
from repro_torch.models import build_model as tbuild
from repro_torch.models import encdec as tencdec
from repro_torch.models import from_jax_params
from repro_torch.train.step import _value_and_grad

from torch_port_util import cuda_device, jax_params_np, pin_calibration
from torch_port_util import one_thread, to_np  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
pytestmark = pytest.mark.usefixtures("one_thread")
ARCH = "whisper-small"


@pytest.fixture(scope="module")
def models():
    jcfg = jget(ARCH, smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget(ARCH, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_tree(t_tree, j_tree, **tol):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(to_np(t), np.asarray(j),
                                   err_msg=str(path), **tol)


def _frames(cfg, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_max_len, cfg.frontend_dim)).astype(np.float32)


def test_encode_matches(models):
    jcfg, _, jp, tcfg, _, tp = models
    fr = _frames(tcfg, 2)
    want = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp,
                                                            jnp.asarray(fr))
    got = tencdec.encode(tp, tcfg, _t(fr))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("frames", [True, False])
def test_prefill_decode_and_slots_match(models, frames):
    """Prefill (with frames, and with none: the zero window), the cache
    with its cross-attention snapshot, 3 gang decode steps and 3 slot
    decode steps from it."""
    jcfg, jm, jp, tcfg, tm, tp = models
    toks = (np.arange(20, dtype=np.int32).reshape(2, 10) * 7 + 3) % 256
    last = np.array([9, 6], np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    if frames:
        fr = _frames(tcfg, 2, seed=1)
        jb["frames"], tb["frames"] = jnp.asarray(fr), _t(fr)
    jl, jc = jax.jit(jm.prefill)(jp, jb, jm.init_cache(2, 16),
                                 last_pos=jnp.asarray(last))
    tl_, tc = tm.prefill(tp, tb, tm.init_cache(2, 16), last_pos=_t(last))
    np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
    _close_tree(tc, jc, **TOL)
    jc2 = jax.tree.map(lambda a: a, jc)
    tc2 = {k: v.clone() for k, v in tc.items()}
    tok0 = tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, 10 + i)
        tl_, tc = tm.decode_step(tp, _t(tok).long(), tc, 10 + i)
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    _close_tree(tc, jc, **TOL)
    tok = tok0
    jdec = jax.jit(jm.decode_step_slots)
    for i in range(3):
        pos = last + 1 + i
        jl, jc2 = jdec(jp, jnp.asarray(tok), jc2, jnp.asarray(pos))
        tl_, tc2 = tm.decode_step_slots(tp, _t(tok).long(), tc2, _t(pos))
        np.testing.assert_allclose(to_np(tl_), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_loss_and_every_gradient_match(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (2, 12)).astype(np.int32),
             "labels": rng.integers(-1, 256, (2, 12)).astype(np.int32),
             "frames": _frames(tcfg, 2, seed=4)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = to_torch(batch, "cpu")
    (tl_, tmet), tg = _value_and_grad(lambda p, b: tm.loss(p, b), tp, tb)
    np.testing.assert_allclose(float(tl_), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _close_tree(tg, jg, **TOL)
    assert float(tg["frontend"].abs().max()) > 0
    for remat in ("full", "dots"):
        (loss, _), g = _value_and_grad(
            lambda p, b: tm.loss(p, b, remat=remat), tp, tb)
        assert torch.equal(loss, tl_)
        for (path, a), (_, b) in zip(tree_flatten(g), tree_flatten(tg)):
            assert torch.equal(a, b), (remat, path)


def test_prefill_records_match(models, monkeypatch):
    """A prefill through a cord dataplane records ``repro``'s edges:
    ``enc/in``, the encoder body once an encoder layer, the decoder body
    (self and cross attention, ``layer/out``) once a decoder layer."""
    pin_calibration(monkeypatch)
    jcfg, jm, jp, tcfg, tm, tp = models
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True),
                     mesh=compat.make_mesh((8,), ("data",)))
    toks = np.arange(7, dtype=np.int32)[None]
    jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 7),
               dp=jdp)
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), device="cpu")
    tm.prefill(tp, {"tokens": _t(toks).long()}, tm.init_cache(1, 7), dp=tdp)
    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    tags = [r["tag"] for r in jrecs]
    assert tags[0] == "enc/in"
    enc_body = jrecs[1:tags.index("embed/table")]
    rest = jrecs[1 + len(enc_body):]
    dec_body = rest[2:[r["tag"] for r in rest].index("logits/table")]
    assert [r["tag"] for r in dec_body][-1] == "layer/out"
    want = (jrecs[:1] + enc_body * tcfg.encoder_layers + rest[:2]
            + dec_body * tcfg.num_layers + rest[2 + len(dec_body):])
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want


# (B, Sq, Skv, H, KVH, D): the cross-attention's Sq != Skv both ways
CROSS = [(2, 12, 32, 4, 4, 16), (1, 40, 24, 4, 2, 16)]


@pytest.mark.parametrize("case", CROSS)
def test_cross_attention_with_gradient_matches(case):
    """Non-causal attention at Sq != Skv through ``FlashAttention`` (the
    plain forward with its lse, the plain backward) against ``repro``'s
    ``attend_flash`` under ``jax.grad`` and its ``_flash_fwd_impl``'s lse,
    with several q and kv blocks in the backward."""
    b, sq, skv, h, kvh, d = case
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    qp, kp = jnp.arange(sq, dtype=jnp.int32), jnp.arange(skv, dtype=jnp.int32)

    def loss(q, k, v):
        o = attend_flash(q, k, v, q_pos=qp, k_pos=kp, causal=False,
                         window=None)
        return jnp.sum(o * w), o
    (_, jo), jg = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, jlse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              qp, kp, jnp.asarray(0), jnp.ones(skv, bool),
                              False, 0.0, 512, 1024, 1.0 / math.sqrt(d))
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (q, k, v))
    o = attend(tq, tk, tv, q_pos=prefill_positions(sq, torch.device("cpu")),
               k_pos=prefill_positions(skv, torch.device("cpu")),
               causal=False, window=None)
    assert "FlashAttention" in type(o.grad_fn).__name__
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(o), np.asarray(jo), **TOL)
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(to_np(t.grad), np.asarray(j), **TOL)
    _, tlse = fops.flash_attention_plain(*(torch.from_numpy(x.copy())
                                           for x in (q, k, v)),
                                         causal=False, return_lse=True)
    np.testing.assert_allclose(to_np(tlse), np.asarray(jlse), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (256, 1500), (12, 100)])
def test_noncausal_kernel_with_lse_on_card(sq, skv):
    """The kernel non-causal at whisper's shapes (12 heads, D 64, bf16),
    the encoder's 1,500 rows cutting the 64-row tiles, with its lse,
    against its plain version."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn((1, sq, 12, 64), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, skv, 12, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = fops.flash_attention(q, k, v, causal=False, return_lse=True)
    po, plse = fops.flash_attention_plain(q, k, v, causal=False,
                                          return_lse=True)
    assert float((o.float() - po.float()).abs().max()) <= 1e-2
    err = (lse - plse).abs()
    assert bool((err <= 2e-5 * torch.clamp(plse.abs(), min=1.0)).all())
