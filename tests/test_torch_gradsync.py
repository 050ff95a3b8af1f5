"""Port parity for the gradient sync through the dataplane
(``repro_torch.train.gradsync``) and the bucketing it uses.

``repro``'s ``sync_grads`` runs inside ``shard_map`` over a 2- and an
8-device mesh; the port's runs on rank-stacked (R, ...) gradients.
Tolerance: exact for the uncompressed means and for the records — the
gradients are multiples of 1/8 of at most 64 in magnitude, so every sum
over ranks is exact in float32 whatever its order; runtime reports equal
as dicts.  Under int8 the quantized payloads are equal, and the means
and residuals within float32 2e-5 (rtol and atol): XLA fuses the
dequantize-and-subtract under ``jit`` (one rounding where torch makes
two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core import policies as jpol
from repro.core.chunking import bucket_pytree as jbucket
from repro.core.dataplane import Dataplane as JDataplane
from repro.train import gradsync as jgs

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core import policies as tpol
from repro_torch.core.chunking import bucket_pytree as tbucket
from repro_torch.core.chunking import split_chunks
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core.tree import tree_flatten
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import gradsync as tgs

from torch_port_util import bits, pin_calibration

TENANTS = ("train", "alice", "bob")
SHAPES = {"embed": {"tok": (64, 32)}, "final_norm": {"scale": (32,)},
          "layers": {"attn": {"wq": (2, 32, 48), "k_norm": {"scale": (2, 16)}},
                     "mlp": {"wi": (2, 32, 64), "wo": (2, 64, 32)}}}


def _grads(r, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.integers(-512, 512, (r,) + s) / 8.0).astype(
            np.float32), SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _dps(r, compression_bytes=None):
    kw = dict(mode="cord", emulate_costs=True)
    pols = lambda m: [m.TelemetryPolicy(),  # noqa: E731
                      m.QoSPolicy(rates={"train": 0.25}, burst=2.0,
                                  stall_ns=100.0)]
    mesh = compat.make_mesh((r,), ("data",), devices=jax.devices()[:r])
    jdp = JDataplane(JCfg(**kw), mesh=mesh, tenant="train", tenants=TENANTS,
                     policies=pols(jpol))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((r,), ("data",)),
                     tenant="train", tenants=TENANTS, policies=pols(tpol),
                     device="cpu")
    return mesh, jdp, tdp


def _to_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_sync(mesh, jdp, grads, err, compression, bucket_bytes):
    def body(g, e, st):
        g = jax.tree.map(lambda x: x[0], g)
        e = None if e is None else jax.tree.map(lambda x: x[0], e)
        mean, new_err, st = jgs.sync_grads(jdp, g, "data",
                                           bucket_bytes=bucket_bytes,
                                           compression=compression,
                                           err_state=e, state=st)
        lift = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lift(mean), lift(new_err), st
    f = compat.shard_map(body, mesh=mesh,
                         in_specs=(P("data"), P("data"), P()),
                         out_specs=(P("data"), P("data"), P()))
    return jax.jit(f)(jax.tree.map(jnp.asarray, grads),
                      None if err is None else jax.tree.map(jnp.asarray, err),
                      jdp.runtime_init())


def _same(t_tree, j_tree, exact=True):
    for (path, t), j in zip(tree_flatten(t_tree), jax.tree.leaves(j_tree)):
        assert tuple(t.shape) == np.shape(j), path
        if exact:
            np.testing.assert_array_equal(bits(t), bits(j), err_msg=str(path))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                                       atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("bucket_bytes", [1 << 22, 9000])
@pytest.mark.parametrize("r", [2, 8])
def test_sync_grads_matches_shard_map(r, bucket_bytes, compression,
                                      monkeypatch):
    pin_calibration(monkeypatch)
    mesh, jdp, tdp = _dps(r)
    g = _grads(r)
    err = None
    if compression == "int8":   # a nonzero residual on the large leaves
        err = jax.tree.map(lambda a: (a / 64.0 if a[0].size >= 1024
                                      else np.zeros((r,), np.float32)),
                           _grads(r, seed=1))
    jmean, jerr, jst = _jax_sync(mesh, jdp, g, err, compression, bucket_bytes)
    tmean, terr, tst = tgs.sync_grads(
        tdp, _to_t(g), "data", bucket_bytes=bucket_bytes,
        compression=compression,
        err_state=None if err is None else _to_t(err), state=tdp.runtime_init())
    _same(tmean, jmean, exact=compression == "none")
    _same(terr, jerr, exact=compression == "none")
    for (path, m) in tree_flatten(tmean):   # every rank holds the mean
        assert torch.equal(m, m[:1].expand_as(m)), path
    jrec, trec = list(jdp.telemetry.records), list(tdp.telemetry.records)
    assert [(a.kind, a.tag, a.bytes, a.shape, a.dtype, a.qos) for a in trec] \
        == [(a.kind, a.tag, a.bytes, a.shape, a.dtype, a.qos) for a in jrec]
    assert tdp.runtime_report(tst) == jdp.runtime_report(jst)


def test_bucket_tags_reverse_order_and_int8_pairs(monkeypatch):
    """Buckets go out last first; under int8 a leaf of >= 1024 elements
    is two psums (int32 payload on ``grads``, its scale on
    ``grads-small``) and a smaller leaf one."""
    pin_calibration(monkeypatch)
    _, _, tdp = _dps(2)
    g = _to_t(_grads(2))
    local = jax.tree.map(lambda t: t[0], g)
    buckets = tbucket(local, 9000)
    sizes = [[p for p, _ in b] for b in buckets]
    assert sizes == [[tuple(str(k.key) for k in p) for p, _ in b]
                     for b in jbucket(jax.tree.map(lambda t: np.asarray(t),
                                                   local), 9000)]
    tgs.sync_grads(tdp, g, "data", bucket_bytes=9000, compression="int8",
                   state=tdp.runtime_init())
    tags = [(r.tag, r.qos, r.dtype) for r in tdp.telemetry.records]
    want = []
    for bi in reversed(range(len(buckets))):
        for _, leaf in buckets[bi]:
            if leaf.numel() >= 1024:
                want += [(f"grads/bucket{bi}", "grads", "int32"),
                         (f"grads/scale{bi}", "grads-small", "float32")]
            else:
                want.append((f"grads/bucket{bi}", "grads", "float32"))
    assert tags == want


def test_error_feedback_carries_the_residual():
    """Quantize-dequantize plus the new residual gives back the input and
    the old residual exactly as float32 adds do; over steps the residual
    stays below one quantization step."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    err = torch.zeros_like(g)
    for _ in range(4):
        q, scale, new_err = tgs.compress_error_feedback(g, err)
        total = g + err
        assert torch.equal(tgs.dequantize_int8(q, scale) + new_err, total)
        assert bool((new_err.abs() <= scale / 2 + 1e-6).all())
        jq, js = jgs.quantize_int8(jnp.asarray(total.numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        err = new_err


def test_err_state_init_matches():
    params = jax.tree.map(lambda a: a[0], _grads(1))
    assert tgs.err_state_init(_to_t(params), "none") is None
    jerr = jgs.err_state_init(jax.tree.map(jnp.asarray, params), "int8")
    terr = tgs.err_state_init(_to_t(params), "int8")
    _same(terr, jerr)


@pytest.mark.parametrize("n,k", [(10, 3), (12, 4), (2, 5)])
def test_split_chunks_matches(n, k):
    from repro.core.chunking import split_chunks as jsplit
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    for a, b in zip(split_chunks(torch.from_numpy(x), k),
                    jsplit(jnp.asarray(x), k)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
