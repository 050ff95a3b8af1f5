"""Port parity for the dataplane's explicit collectives over rank-stacked
tensors (``Dataplane.psum`` / ``all_gather`` / ``reduce_scatter`` /
``all_to_all`` / ``ppermute``) and the QoS stall.

``repro`` runs each collective inside ``shard_map`` on a 2- and an
8-device mesh; the port runs it on a (R, ...) tensor whose slice r is
rank r's shard.  Tolerance: exact — outputs bit for bit (payloads are
integer-valued, so the order in which the ranks are added cannot move a
sum), records field by field, runtime reports equal as dicts.  The
``cuda``-marked tests hold the card's stall: ``x`` itself back, no
stream sync under ``torch.cuda.set_sync_debug_mode("error")``, one launch
per rank, and counters equal to the CPU path's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core import policies as jpol
from repro.core.dataplane import Dataplane as JDataplane

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core import policies as tpol
from repro_torch.core import techniques as ttech
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.kernels.dataplane import stall as tstall
from repro_torch.launch.mesh import make_mesh

from torch_port_util import PROBE_ITERS, bits, cuda_device, pin_calibration

TENANTS = ("train", "alice", "bob")
RECORD_FIELDS = ("kind", "tag", "bytes", "axes", "shape", "dtype", "mode",
                 "qos", "count", "precharged")

OPS = [("psum", dict(tag="g/psum", qos="grads")),
       ("all_gather", dict(tag="g/ag", gather_axis=0)),
       ("all_gather", dict(tag="g/ag_tiled", gather_axis=1, tiled=True)),
       ("reduce_scatter", dict(tag="g/rs", scatter_axis=0)),
       ("all_to_all", dict(tag="g/a2a", split_axis=0, concat_axis=1)),
       ("ppermute", dict(tag="g/shift", perm="cyclic")),
       ("ppermute", dict(tag="g/one", perm=((0, 1),))),
       ("psum", dict(tag="g/psum2", tenant="bob", qos="grads-small"))]


def _policies(mod, stall_ns=200.0):
    return [mod.TelemetryPolicy(),
            mod.QoSPolicy(rates={"train": 0.25, "bob": 0.5}, burst=2.0,
                          stall_ns=stall_ns)]


def _kw(kw, r):
    kw = dict(kw)
    if kw.get("perm") == "cyclic":
        kw["perm"] = tuple((i, (i + 1) % r) for i in range(r))
    return kw


def _mesh(r):
    return compat.make_mesh((r,), ("data",), devices=jax.devices()[:r])


def _run_jax(r, x, mode):
    jdp = JDataplane(JCfg(mode=mode, emulate_costs=True), mesh=_mesh(r),
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))

    def body(v, st):
        outs = []
        for name, kw in OPS:
            o, st = getattr(jdp, name)(v[0], "data", state=st, **_kw(kw, r))
            outs.append(o[None])
        return tuple(outs), st

    f = compat.shard_map(body, mesh=_mesh(r), in_specs=(P("data"), P()),
                         out_specs=(tuple(P("data") for _ in OPS), P()))
    outs, st = jax.jit(f)(jnp.asarray(x), jdp.runtime_init())
    return [np.asarray(o) for o in outs], jdp, st


def _run_port(r, x, mode, device="cpu"):
    tdp = TDataplane(TCfg(mode=mode, emulate_costs=True),
                     mesh=make_mesh((r,), ("data",)), tenant="train",
                     tenants=TENANTS, policies=_policies(tpol),
                     device=device)
    st = tdp.runtime_init()
    xt = torch.from_numpy(x.copy()).to(device)
    outs = []
    for name, kw in OPS:
        o, st = getattr(tdp, name)(xt, "data", state=st, **_kw(kw, r))
        outs.append(o)
    return outs, tdp, st


def _payload(r, dtype):
    rng = np.random.default_rng(r)
    return rng.integers(-50, 50, (r, 2 * r, 6)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("mode", ["cord", "socket"])
@pytest.mark.parametrize("r", [2, 8])
def test_collectives_match_shard_map(r, mode, dtype, monkeypatch):
    pin_calibration(monkeypatch)
    x = _payload(r, dtype)
    jouts, jdp, jst = _run_jax(r, x, mode)
    touts, tdp, tst = _run_port(r, x, mode)
    for (name, _), jo, to in zip(OPS, jouts, touts):
        assert tuple(to.shape) == jo.shape, name
        np.testing.assert_array_equal(bits(to), bits(jo), err_msg=name)
    jrec, trec = list(jdp.telemetry.records), list(tdp.telemetry.records)
    assert len(trec) == len(jrec) == len(OPS)
    for a, b in zip(trec, jrec):
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a, b)
    assert tdp.runtime_report(tst) == jdp.runtime_report(jst)
    np.testing.assert_array_equal(tst["qos"]["tokens"].numpy(),
                                  np.asarray(jst["qos"]["tokens"]))


def test_collectives_without_state_and_their_refusals():
    tdp = TDataplane(TCfg(mode="cord"), mesh=make_mesh((2,), ("data",)),
                     device="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    out, st = tdp.psum(x, "data")
    assert st is None
    np.testing.assert_array_equal(out.numpy(), [[4, 6, 8, 10]] * 2)
    with pytest.raises(ValueError, match="leading dim 2"):
        tdp.psum(torch.ones(3, 4), "data")
    with pytest.raises(ValueError, match="need a mesh"):
        TDataplane(TCfg(), device="cpu").psum(x, "data")
    assert tdp.with_mode("socket").mode == "socket"


def _throttle_sequence(dp, n_ops, make):
    st = dp.runtime_init()
    for i in range(n_ops):
        tenant = ("train", "bob", "alice")[i % 3]
        _, st = dp.psum(make(i), "data", tag=f"t{i}", qos="grads",
                        state=st, tenant=tenant)
    return st


@pytest.mark.parametrize("stall_ns", [0.0, 200.0])
def test_qos_stall_throttled_counts(stall_ns, monkeypatch):
    """The token bucket's throttled counts, tokens and counters after 30
    psums equal ``repro``'s; the stall leaves the payloads unchanged."""
    pin_calibration(monkeypatch)
    r = 2
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=_mesh(r),
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol, stall_ns))
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((r,), ("data",)), tenant="train",
                     tenants=TENANTS, policies=_policies(tpol, stall_ns),
                     device="cpu")
    xs = [np.full((r, 3), i, np.float32) for i in range(30)]

    def body(st):
        for i, x in enumerate(xs):
            _, st = jdp.psum(jnp.asarray(x[0]), "data", tag=f"t{i}",
                             qos="grads", state=st,
                             tenant=("train", "bob", "alice")[i % 3])
        return st
    jst = jax.jit(compat.shard_map(body, mesh=_mesh(r), in_specs=P(),
                                   out_specs=P()))(jdp.runtime_init())
    tst = _throttle_sequence(tdp, 30,
                             lambda i: torch.from_numpy(xs[i]))
    rep = tdp.runtime_report(tst)
    assert rep == jdp.runtime_report(jst)
    assert rep["train"]["throttled"] > 0 and rep["bob"]["throttled"] > 0
    assert rep["alice"]["throttled"] == 0
    np.testing.assert_array_equal(tst["qos"]["tokens"].numpy(),
                                  np.asarray(jst["qos"]["tokens"]))


def test_stall_plain_is_value_identical():
    x = torch.tensor([float("nan"), -0.0, 3.0])
    n0 = tstall.LAUNCHES
    for it in (torch.tensor(0, dtype=torch.int32),
               torch.tensor(-5, dtype=torch.int32), 300):
        out = ttech.delay_chain_dyn(x, it)
        np.testing.assert_array_equal(bits(out), bits(x))
    assert tstall.LAUNCHES == n0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_stall_returns_x_and_never_syncs():
    dev = cuda_device()
    x = torch.randn(1 << 16, device=dev)
    keep = x.clone()
    iters = torch.full((), 5000, dtype=torch.int32, device=dev)
    ttech.delay_chain_dyn(x, iters)          # build and load first
    torch.cuda.synchronize()
    n0 = tstall.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [ttech.delay_chain_dyn(x, iters * k) for k in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(o is x for o in outs)
    np.testing.assert_array_equal(bits(x), bits(keep))
    assert tstall.LAUNCHES - n0 == 3


@pytest.mark.cuda
def test_card_qos_psums_match_cpu_and_never_sync(monkeypatch):
    """The same psums with the QoS stall on the card and on the CPU give
    equal reports (the stall bumps no counter; the cost kernel's counters
    equal the CPU's static split), equal sums, R stall launches an op,
    and no stream sync."""
    dev = cuda_device()
    monkeypatch.setitem(ttech._CALIBRATION, ("cpu", PROBE_ITERS), 1.0)
    monkeypatch.setitem(ttech._CALIBRATION, ("cuda", PROBE_ITERS), 1.0)
    r, n_ops = 2, 12
    xs = [torch.randn(r, 5000 + i, generator=torch.Generator().manual_seed(i))
          for i in range(n_ops)]
    cpu = TDataplane(TCfg(mode="cord", emulate_costs=True,
                          pallas_dataplane="on"),
                     mesh=make_mesh((r,), ("data",)), tenant="train",
                     tenants=TENANTS, policies=_policies(tpol), device="cpu")
    card = TDataplane(TCfg(mode="cord", emulate_costs=True),
                      mesh=make_mesh((r,), ("data",)), tenant="train",
                      tenants=TENANTS, policies=_policies(tpol), device=dev)
    cst = _throttle_sequence(cpu, n_ops, lambda i: xs[i])
    card_xs = [x.to(dev) for x in xs]
    card.psum(card_xs[0], "data")          # build and load first
    torch.cuda.synchronize()
    n0 = tstall.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        gst = _throttle_sequence(card, n_ops, lambda i: card_xs[i])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    governed = sum(1 for i in range(n_ops) if i % 3 != 2)
    assert tstall.LAUNCHES - n0 == r * governed
    assert card.runtime_report(gst) == cpu.runtime_report(cst)
    out, _ = card.psum(card_xs[3], "data")
    assert torch.equal(out.cpu(), (xs[3][0] + xs[3][1]).expand(r, -1))
