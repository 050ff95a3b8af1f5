"""Port parity for the mediation pipeline and the dataplane.

The same records and payloads go through repro's and repro_torch's
``pipeline.send`` / ``complete`` with a runtime state, over modes ×
fused × policy sets.  Tolerance: exact — payloads bit for bit, runtime
reports equal as dicts.

Telemetry differs by design: JAX records an edge when it is traced (a
``lax.scan`` layer body once), the port each time it runs, so the port's
records and totals equal JAX's with the layer body repeated
``num_layers`` times."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.core.dataplane import Dataplane as JDataplane
from repro.core import policies as jpol
from repro.core import telemetry as jtl
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core import policies as tpol
from repro_torch.core import telemetry as ttl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params

from torch_port_util import bits, jax_params_np, pin_calibration

TENANTS = ("train", "alice", "bob")
POLICY_SETS = ("telemetry", "quota", "qos")


def _policies(mod, which):
    pols = [mod.TelemetryPolicy()]
    if which == "quota":
        pols.append(mod.QuotaPolicy(limits={"alice": 600, "train": 10_000},
                                    hard=False))
    if which == "qos":
        pols.append(mod.QoSPolicy(rates={"train": 0.25, "bob": 0.5},
                                  burst=2.0, stall_ns=50.0))
    return pols


def _dataplanes(mode, fused, which, mesh8):
    kw = dict(mode=mode, emulate_costs=True, fuse_mediation=fused)
    jdp = JDataplane(JCfg(**kw), mesh=mesh8, tenant="train", tenants=TENANTS,
                     policies=_policies(jpol, which))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((8,), ("data",)),
                     tenant="train", tenants=TENANTS,
                     policies=_policies(tpol, which), device="cpu")
    return jdp, tdp


def _ops():
    rng = np.random.default_rng(7)
    shapes = [(16,), (4, 8), (33,), (2, 3, 5), (64,), (16,)]
    tenants = ["train", "alice", "bob", "alice", "train", "bob"]
    for i, (shape, tenant) in enumerate(zip(shapes, tenants)):
        x = rng.standard_normal(shape).astype(np.float32)
        if i == 3:
            x.flat[0] = np.nan
            x.flat[1] = -0.0
        yield f"op{i}", x, tenant


@pytest.mark.parametrize("which", POLICY_SETS)
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["bypass", "cord", "socket"])
def test_pipeline_send_complete_matches_jax(mode, fused, which, mesh8,
                                            monkeypatch):
    pin_calibration(monkeypatch)
    jdp, tdp = _dataplanes(mode, fused, which, mesh8)
    assert tdp.pipeline.stage_names == jdp.pipeline.stage_names
    assert repr(tdp.pipeline) == repr(jdp.pipeline)
    jst, tst = jdp.runtime_init(), tdp.runtime_init()
    for tag, x, tenant in _ops():
        jrec = jtl.OpRecord(kind="all_reduce", tag=tag, bytes=x.nbytes,
                            axes=("data",), shape=x.shape, dtype="float32",
                            mode=mode)
        trec = ttl.OpRecord(**dataclasses.asdict(jrec))
        ti = jdp.tenant_index(tenant)
        assert ti == tdp.tenant_index(tenant)
        jx, jst = jdp.pipeline.send(jax.numpy.asarray(x), jrec, jst, ti)
        tx, tst = tdp.pipeline.send(torch.from_numpy(x.copy()), trec, tst, ti)
        jx, jst = jdp.pipeline.complete(jx, jrec, jst, ti)
        tx, tst = tdp.pipeline.complete(tx, trec, tst, ti)
        np.testing.assert_array_equal(bits(tx), bits(jx))
        np.testing.assert_array_equal(bits(tx), x.view(np.int32))
        for side in ("send", "complete"):
            assert getattr(tdp.pipeline, f"{side}_delay_iters")(trec) == \
                getattr(jdp.pipeline, f"{side}_delay_iters")(jrec)
            assert getattr(tdp.pipeline, f"{side}_copies")(trec) == \
                getattr(jdp.pipeline, f"{side}_copies")(jrec)
    assert tdp.runtime_report(tst) == jdp.runtime_report(jst)
    if which == "qos":
        np.testing.assert_array_equal(tst["qos"]["tokens"].numpy(),
                                      np.asarray(jst["qos"]["tokens"]))


@pytest.mark.parametrize("pallas", ["on", "off"])
def test_pipeline_pallas_on_off_identical(pallas, mesh8, monkeypatch):
    """pallas on (the fused kernel path, its plain version here) and off
    (the explicit emulation) give JAX's reports and payloads."""
    pin_calibration(monkeypatch)
    kw = dict(mode="socket", emulate_costs=True, pallas_dataplane=pallas)
    jdp = JDataplane(JCfg(**kw), mesh=mesh8)
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((8,), ("data",)),
                     device="cpu")
    assert tdp.pipeline.pallas is (pallas == "on")
    jst, tst = jdp.runtime_init(), tdp.runtime_init()
    for tag, x, _ in _ops():
        rec = dict(kind="all_gather", tag=tag, bytes=x.nbytes,
                   axes=("data",))
        jx, jst = jdp.pipeline.send(jax.numpy.asarray(x), jtl.OpRecord(**rec),
                                    jst)
        tx, tst = tdp.pipeline.send(torch.from_numpy(x.copy()),
                                    ttl.OpRecord(**rec), tst)
        np.testing.assert_array_equal(bits(tx), bits(jx))
    assert tdp.runtime_report(tst) == jdp.runtime_report(jst)


@pytest.mark.parametrize("mode", ["bypass", "cord", "socket"])
def test_constrain_records_match_jax(mode, mesh8, monkeypatch):
    pin_calibration(monkeypatch)
    rules = {"batch": "data", "embed": None, "seq": None}
    jdp = JDataplane(JCfg(mode=mode, emulate_costs=True), mesh=mesh8,
                     rules=rules, tenant="alice", tenants=TENANTS)
    tdp = TDataplane(TCfg(mode=mode, emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), rules=rules,
                     tenant="alice", tenants=TENANTS, device="cpu")
    x = np.random.default_rng(3).standard_normal((8, 4, 6)).astype(np.float32)
    names = ("batch", "seq", "embed")
    assert tdp.spec(names) == tuple(jdp.spec(names))
    jy = jdp.constrain(jax.numpy.asarray(x), names, tag="act/x", qos="kv")
    ty = tdp.constrain(torch.from_numpy(x.copy()), names, tag="act/x",
                       qos="kv")
    np.testing.assert_array_equal(bits(ty), bits(jy))
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == \
        [dataclasses.asdict(r) for r in jdp.telemetry.records]
    # without a mesh the edge is not a dataplane op
    bare = TDataplane(TCfg(mode=mode), device="cpu")
    t = torch.ones(3)
    assert bare.constrain(t, ("batch",)) is t
    assert not bare.telemetry.records


def test_prefill_records_repeat_scan_body(monkeypatch):
    """A prefill through a cord dataplane records JAX's edges with the
    layer body once per layer."""
    pin_calibration(monkeypatch)
    jcfg = jget("gemma3-1b", smoke=True)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    from repro.core import compat
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True),
                     mesh=compat.make_mesh((8,), ("data",)))
    tokens = np.arange(8, dtype=np.int32)[None] % jcfg.vocab_size
    jmodel.prefill(params, {"tokens": jax.numpy.asarray(tokens)},
                   jmodel.init_cache(1, 8), dp=jdp)

    tcfg = tget("gemma3-1b", smoke=True)
    tmodel = tbuild(tcfg, device="cpu")
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), device="cpu")
    tmodel.prefill(from_jax_params(jax_params_np(params), tcfg, "cpu"),
                   {"tokens": torch.from_numpy(tokens).long()},
                   tmodel.init_cache(1, 8), dp=tdp)

    jrecs = [dataclasses.asdict(r) for r in jdp.telemetry.records]
    body = [r for r in jrecs if r["tag"].startswith(("attn/", "mlp/",
                                                     "layer/"))]
    head = jrecs[:2]
    tail = jrecs[2 + len(body):]
    assert [r["tag"] for r in head] == ["embed/table", "embed/out"]
    assert [r["tag"] for r in tail] == ["logits/table", "logits/out"]
    want = head + body * tcfg.num_layers + tail
    assert [dataclasses.asdict(r) for r in tdp.telemetry.records] == want
    assert len(want) == 4 + 7 * tcfg.num_layers
    # the totals are JAX's with the layer body's counted once per layer
    body_tags = {r["tag"] for r in body}
    want_tags = {tag: {k: n * (tcfg.num_layers if tag in body_tags else 1)
                       for k, n in v.items()}
                 for tag, v in jdp.telemetry.by_tag().items()}
    assert tdp.telemetry.by_tag() == want_tags
    assert tdp.telemetry.total_bytes() == \
        sum(v["bytes"] for v in want_tags.values())


def test_telemetry_totals_match_jax_and_records_are_bounded(monkeypatch):
    """Totals equal JAX's over the same record stream; the port keeps only
    the newest ``KEEP_RECORDS`` records, the totals cover all of them."""
    monkeypatch.setattr(ttl, "KEEP_RECORDS", 4)
    jtel, ttel = jtl.Telemetry(), ttl.Telemetry()
    recs = [dict(kind=("all_reduce", "constraint")[i % 2], tag=f"t{i % 3}",
                 bytes=8 * (i + 1), axes=("data",), count=1 + i % 2)
            for i in range(10)]
    for rec in recs:
        jtel.record(jtl.OpRecord(**rec))
        ttel.record(ttl.OpRecord(**rec))
    assert ttel.by_kind() == jtel.by_kind()
    assert ttel.by_tag() == jtel.by_tag()
    assert ttel.total_bytes() == jtel.total_bytes()
    assert ttel.total_bytes(("constraint",)) == \
        jtel.total_bytes(("constraint",))
    assert ttel.report() == jtel.report()
    assert [r.tag for r in ttel.records] == [r["tag"] for r in recs[-4:]]
    ttel.reset()
    assert not ttel.records and ttel.total_bytes() == 0
