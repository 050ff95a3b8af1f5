"""Port parity for the vlm family of the transformer on the llava-next-34b
smoke config (8 patches of frontend_dim 32 projected in front of the
text): ``Model.apply``, the loss and every gradient with patches
(``vision_proj`` included), a prefill with a prefix and ``last_pos``
then decode, text-only prefill, ``_text_len``, ``input_specs`` and
``make_batch``.  JAX parameters reach the port through
``from_jax_params``; inputs are numpy.

Tolerances: float32 2e-5 (rtol and atol) for hiddens, logits, caches,
losses and gradients, as tests/test_kernels.py holds f32; shapes, dtypes
and prefix lengths exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.models import api as japi
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core.tree import tree_flatten
from repro_torch.models import api as tapi
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.train.step import _value_and_grad

from torch_port_util import jax_params_np, to_np
from torch_port_util import one_thread  # noqa: F401 (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
pytestmark = pytest.mark.usefixtures("one_thread")
ARCH = "llava-next-34b"
P, TEXT = 8, 12


@pytest.fixture(scope="module")
def models():
    jcfg = jget(ARCH, smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget(ARCH, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _batch(cfg, b=2, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, TEXT)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    patches = rng.standard_normal((b, P, cfg.frontend_dim)) \
        .astype(np.float32) + np.float32(shift)
    return {"tokens": toks, "labels": labels, "patches": patches}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()).long() if v.dtype == np.int32
            else torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_params_and_refusal(models):
    jcfg, _, jp, tcfg, tm, tp = models
    assert tcfg.num_patches == P
    assert tuple(tp["vision_proj"].shape) == (tcfg.frontend_dim, tcfg.d_model)
    own = tm.init(0)
    assert [(p, tuple(t.shape)) for p, t in tree_flatten(own)] == \
        [(p, tuple(t.shape)) for p, t in tree_flatten(tp)]
    np_params = jax_params_np(jp)
    del np_params["vision_proj"]
    with pytest.raises(ValueError, match="no vision_proj"):
        from_jax_params(np_params, tcfg, device="cpu")


def test_apply_with_patches_matches(models):
    jcfg, jm, jp, _, tm, tp = models
    batch = _batch(jcfg)
    jx, jaux, jcache, jprefix = jm.apply(jp, _jb(batch))
    tx, taux, tcache, tprefix = tm.apply(tp, _tb(batch))
    assert tprefix == jprefix == P and tcache is jcache is None
    assert tuple(tx.shape) == (2, P + TEXT, jcfg.d_model)
    np.testing.assert_allclose(to_np(tx), np.asarray(jx), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_loss_and_grads_with_patches_match(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    batch = _batch(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, _jb(batch))
    (tl, tmet), tg = _value_and_grad(lambda p, b: tm.loss(p, b), tp,
                                     _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in ("loss", "nll", "acc", "tokens"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    for (path, t), j in zip(tree_flatten(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(to_np(t), np.asarray(j),
                                   err_msg=str(path), **TOL)
    assert float(tg["vision_proj"].abs().max()) > 0


def test_shifted_patches_change_the_loss(models):
    jcfg, _, _, _, tm, tp = models
    base, _ = tm.loss(tp, _tb(_batch(jcfg)))
    moved, _ = tm.loss(tp, _tb(_batch(jcfg, shift=1.0)))
    assert abs(float(moved) - float(base)) > 1e-4
    # and without patches the loss is the text-only model's
    text = {k: v for k, v in _batch(jcfg).items() if k != "patches"}
    alone, _ = tm.loss(tp, _tb(text))
    assert abs(float(alone) - float(base)) > 1e-4


@pytest.mark.parametrize("patches", [True, False])
def test_prefill_with_prefix_then_decode_match(models, patches):
    """A right-padded prompt behind the patch prefix: the logits at
    ``last_pos`` (counted in text tokens) and the cache, then slot
    decode from prefix + text."""
    jcfg, jm, jp, _, tm, tp = models
    batch = _batch(jcfg, seed=3)
    batch.pop("labels")
    if not patches:
        batch.pop("patches")
    prefix = P if patches else 0
    last = np.array([TEXT - 1, 6], np.int32)
    s = prefix + TEXT + 4
    jl, jc = jax.jit(jm.prefill)(jp, _jb(batch), jm.init_cache(2, s),
                                 last_pos=jnp.asarray(last))
    tl, tc = tm.prefill(tp, _tb(batch), tm.init_cache(2, s),
                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    pos = prefix + last + 1
    slots = jax.jit(jm.decode_step_slots)
    for _ in range(3):
        jl, jc = slots(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step_slots(tp, torch.from_numpy(tok).long(), tc,
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "short"])
@pytest.mark.parametrize("arch,smoke", [(ARCH, False), (ARCH, True),
                                        ("grok-1-314b", True)])
def test_text_len_and_input_specs_match(shape, arch, smoke):
    jcfg, tcfg = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    if shape == "short":     # a cell shorter than the prefix: 16 text tokens
        jsh, tsh = JShape("short", 40, 2, "train"), TShape("short", 40, 2,
                                                          "train")
    else:
        jsh, tsh = JSHAPES[shape], TSHAPES[shape]
    assert tapi._text_len(tcfg, tsh.seq_len) == \
        japi._text_len(jcfg, jsh.seq_len)
    jspecs = japi.input_specs(jcfg, jsh)
    tspecs = tapi.input_specs(tcfg, tsh)
    assert list(tspecs) == list(jspecs)
    for name, sd in jspecs.items():
        assert tspecs[name].shape == tuple(sd.shape), name
        assert str(tspecs[name].dtype).removeprefix("torch.") == \
            str(sd.dtype), name


def test_make_batch_matches_the_specs(models):
    _, _, _, tcfg, _, _ = models
    shape = TShape("cell", 24, 2, "train")
    gen = torch.Generator().manual_seed(0)
    batch = tapi.make_batch(tcfg, shape, gen, vocab_cap=50)
    specs = tapi.input_specs(tcfg, shape)
    assert list(batch) == list(specs) == ["tokens", "labels", "patches"]
    for name, sd in specs.items():
        assert tuple(batch[name].shape) == sd.shape
        assert batch[name].dtype == sd.dtype
    assert int(batch["tokens"].max()) < 50 and int(batch["tokens"].min()) >= 0
    assert specs["tokens"].shape == (2, 16)    # max(24 - 8, 16)
