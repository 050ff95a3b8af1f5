"""Port parity for the connection table: ``conn_send`` over one shared CQ
and SRQ (lossless, lossy, a fatal QP isolated, SRQ starvation, QoS
arbitration with ``charge_wr``, quota marking, bypass / cord / socket),
the helpers it calls (``QoSPolicy.rates_for`` / ``arb_scores`` /
``charge_wr``, ``tenant_counters_peak``, ``tenant_counters_bump`` at a
tensor index) and the dataplane's per-rank runtime states.

``repro`` runs inside ``shard_map`` on the 2-device ``("rank",)`` mesh,
the port on rank-stacked tensors on the CPU, delay calibration pinned in
both.  Tolerance: exact — payloads bit for bit, every table key and the
aggregated runtime state (every counter, QoS tokens)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpol
from repro.core import telemetry as jtl
from repro.core import verbs as jverbs
from repro.runtime.fault import WireFault as JWireFault

from repro_torch.core import policies as tpol
from repro_torch.core import telemetry as ttl
from repro_torch.core import verbs as tverbs
from repro_torch.runtime.fault import WireFault as TWireFault

import torch_verbs_util as U
from torch_port_util import pin_calibration

CCFG = dict(msg_bytes=32, depth=8, max_outstanding=3, retry_limit=7,
            rto_ticks=4, backoff_ticks=1)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch, request):
    # a card test pins the port's slopes itself: the card has no JAX
    if request.node.get_closest_marker("cuda") is None:
        pin_calibration(monkeypatch)


def _both(mesh2, msgs, *, cfg=CCFG, fault=None, credits=None, tenants=None,
          mode="cord", emulate=False, policies=None):
    """The same table transfer in both packages; ``policies(module)``
    gives each dataplane its policies, over tenants "a" and "b"."""
    if policies is None:
        jdp, tdp = U.dataplanes(mesh2, mode, emulate_costs=emulate)
    else:
        jdp, tdp = U.dataplanes(mesh2, mode, emulate_costs=emulate,
                                jpolicies=policies(jpol),
                                tpolicies=policies(tpol), tenant="a",
                                tenants=("a", "b"))
    jcfg, tcfg = jverbs.QPConfig(**cfg), tverbs.QPConfig(**cfg)
    j = U.jax_conn(mesh2, jdp, jcfg, msgs, tenants=tenants, credits=credits,
                   fault=JWireFault(**fault) if fault else None)
    t = U.torch_conn(tdp, tcfg, msgs, tenants=tenants, credits=credits,
                     fault=TWireFault(**fault) if fault else None)
    U.assert_same(j, t)
    return t, U.report(tdp, t[2])


@pytest.mark.parametrize("fault", [
    None,
    dict(drops=((1 * 4 + 1, 0),)),                 # QP 1's second message
    dict(corrupts=((2 * 4 + 0, 0), (2 * 4 + 0, 1))),
    dict(drop_rate=0.15, corrupt_rate=0.15, seed=7),
])
@pytest.mark.parametrize("mode, emulate", [("cord", False), ("cord", True),
                                           ("socket", True),
                                           ("bypass", True)])
def test_conn_send_matches_repro(mesh2, fault, mode, emulate):
    payload = U.payload((3, 4, 32), 7)
    (out, conn, _), _ = _both(mesh2, U.stack(payload), fault=fault,
                              mode=mode, emulate=emulate)
    np.testing.assert_array_equal(out[1], payload)
    np.testing.assert_array_equal(conn["retry_cnt"], np.zeros(3, np.int32))
    if fault:
        assert conn["retransmits"].sum() > 0


def test_conn_send_fatal_qp_isolated(mesh2):
    cfg = dict(msg_bytes=32, depth=8, max_outstanding=3, retry_limit=2,
               rto_ticks=3, backoff_ticks=1)
    n = 2
    drops = tuple((1 * n + m, a) for m in range(n) for a in range(4))
    payload = U.payload((3, n, 32), 9)
    (out, conn, _), _ = _both(mesh2, U.stack(payload), cfg=cfg,
                              fault=dict(drops=drops), emulate=True)
    assert conn["retry_cnt"][1] > cfg["retry_limit"]
    np.testing.assert_array_equal(out[1, 1], np.zeros_like(payload[1]))
    np.testing.assert_array_equal(out[1, 0], payload[0])
    np.testing.assert_array_equal(out[1, 2], payload[2])


@pytest.mark.parametrize("credits, fault", [
    (2, None), (3, dict(drop_rate=0.2, seed=5))])
def test_srq_starvation_stalls_then_recovers(mesh2, credits, fault):
    payload = U.payload((2, 4, 32), 11)
    (out, _, _), rep = _both(mesh2, U.stack(payload), credits=credits,
                             fault=fault, emulate=True)
    np.testing.assert_array_equal(out[1], payload)
    assert rep["default"]["stalls"] > 0


def _qos(mod):
    return [mod.TelemetryPolicy(),
            mod.QoSPolicy(rates={"b": 0.25}, burst=1.0)]


@pytest.mark.parametrize("fault", [None, dict(drop_rate=0.2, seed=4)])
def test_conn_qos_arbitration_charges_and_throttles(mesh2, fault):
    payload = U.payload((4, 3, 32), 10)
    (out, _, _), rep = _both(mesh2, U.stack(payload), fault=fault,
                             tenants=("a", "b", "a", "b"), policies=_qos)
    np.testing.assert_array_equal(out[1], payload)
    assert rep["b"]["throttled"] > 0 and rep["a"]["throttled"] == 0


def test_conn_quota_marks_over_budget_traffic(mesh2):
    def pols(mod):
        return [mod.TelemetryPolicy(),
                mod.QuotaPolicy(limits={"b": 100}, hard=False)]
    payload = U.payload((2, 4, 32), 11)
    (out, _, _), rep = _both(mesh2, U.stack(payload), tenants=("a", "b"),
                             policies=pols)
    np.testing.assert_array_equal(out[1], payload)
    assert rep["b"]["denied"] > 0


def test_conn_send_rejects_what_repro_rejects():
    cfg = tverbs.QPConfig(**CCFG)
    conn = tverbs.conn_init(cfg, 2, device="cpu")
    msgs = torch.zeros((2, 2, 1, 32), dtype=torch.uint8)
    with pytest.raises(tverbs.TransportError):
        tverbs.conn_send(None, tverbs.QPConfig(transport="UD", msg_bytes=32),
                         conn, msgs, 0, 1)
    with pytest.raises(tverbs.TransportError):
        tverbs.conn_send(None, cfg, conn,
                         torch.zeros((2, 3, 1, 32), dtype=torch.uint8), 0, 1)
    with pytest.raises(tverbs.TransportError):
        tverbs.conn_init(cfg, 0)


# ---------------------------------------------------------------------------
# the helpers conn_send calls
# ---------------------------------------------------------------------------

def test_qos_arbitration_helpers_match_repro():
    kw = dict(rates={"b": 0.25, "c": 0.75}, burst=2.0)
    jq, tq = jpol.QoSPolicy(**kw), tpol.QoSPolicy(**kw)
    tenants = ("a", "b", "c", "b")
    assert tq.rates_for(tenants) == jq.rates_for(tenants)
    tokens = np.array([2.0, 0.5, 1.25], np.float32)
    idx = np.array([0, 1, 2, 1], np.int32)
    rates = np.array(jq.rates_for(tenants), np.float32)
    js = {"qos": {"tokens": jnp.asarray(tokens)},
          "counters": jtl.tenant_counters_init(3)}
    ts = {"qos": {"tokens": torch.from_numpy(tokens.copy())},
          "counters": ttl.tenant_counters_init(3, device="cpu")}
    np.testing.assert_array_equal(
        tq.arb_scores(ts, torch.from_numpy(idx).long(),
                      torch.from_numpy(rates)).numpy(),
        np.asarray(jq.arb_scores(js, jnp.asarray(idx), jnp.asarray(rates))))
    # a charge per tenant, mask and bump mask both ways, the index a
    # Python int or a 0-d tensor (a winner picked at run time)
    for ti, rate in ((0, 0.0), (1, 0.25), (2, 0.75), (1, 0.25)):
        for mask, bump in ((True, True), (True, False), (False, True)):
            for as_tensor in (False, True):
                js = jq.charge_wr(js, jnp.int32(ti), jnp.float32(rate),
                                  jnp.bool_(mask), bump_mask=jnp.bool_(bump))
                args = (ti, rate, mask, bump)
                if as_tensor:
                    args = tuple(torch.tensor(a) for a in args)
                ts = tq.charge_wr(ts, *args[:3], bump_mask=args[3])
                U.assert_same_tree(U.state_np(ts), U.state_np(js))
    assert tq.charge_wr(None, 0, 1.0, True) is None


def test_counter_peak_and_tensor_index_bump_match_repro():
    j = jtl.tenant_counters_init(3)
    t = ttl.tenant_counters_init(3, device="cpu")
    steps = [("bump", 1, dict(credits=2, stalls=1)),
             ("peak", 2, 5), ("peak", 2, 3), ("peak", 0, 0),
             ("bump", 2, dict(ops=1, bytes=4096)), ("peak", 2, 9)]
    for kind, ti, v in steps:
        for as_tensor in (False, True):
            if kind == "bump":
                j = jtl.tenant_counters_bump(j, jnp.int32(ti), **v)
                t = ttl.tenant_counters_bump(
                    t, torch.tensor(ti) if as_tensor else ti,
                    **{k: torch.tensor(float(x)) if as_tensor else x
                       for k, x in v.items()})
            else:
                j = jtl.tenant_counters_peak(j, ti, cq_depth=v + as_tensor)
                t = ttl.tenant_counters_peak(
                    t, ti, cq_depth=torch.tensor(v + 1) if as_tensor else v)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_collectives_take_and_return_per_rank_states(mesh2):
    """A list of R states runs each rank's pipeline on its own state and
    returns R; one state keeps rank 0's result, as before."""
    _, tdp = U.dataplanes(mesh2, "cord", emulate_costs=True)
    x = torch.from_numpy(U.payload((2, 3, 8), 1))
    a = tdp.runtime_init()
    b = {**a, "counters": ttl.tenant_counters_bump(a["counters"], 0, ops=5)}
    out, states = tdp.ppermute(x, "rank", [(0, 1)], state=[a, b])
    out1, st = tdp.ppermute(x, "rank", [(0, 1)], state=a)
    np.testing.assert_array_equal(out.numpy(), out1.numpy())
    assert isinstance(states, list) and len(states) == 2
    np.testing.assert_array_equal(states[0]["counters"].numpy(),
                                  st["counters"].numpy())
    assert tdp.runtime_report(states[1])["default"]["ops"] == 6.0
    with pytest.raises(ValueError):
        tdp.psum(x, "rank", state=[a])


@pytest.mark.cuda
def test_card_conn_send_matches_cpu(monkeypatch):
    """A lossy connection table in socket mode (every ``_pay`` a delay
    chain and a bounce copy) on the card and on the CPU: the same
    delivery, table and report."""
    from repro_torch.configs.base import DataplaneConfig as TCfg
    from repro_torch.core import techniques as ttech
    from repro_torch.core.dataplane import Dataplane as TDataplane
    from repro_torch.launch.mesh import make_mesh
    from torch_port_util import PROBE_ITERS, cuda_device
    cuda_device()
    for kind in ("cpu", "cuda"):
        monkeypatch.setitem(ttech._CALIBRATION, (kind, PROBE_ITERS), 1.0)
    cfg = tverbs.QPConfig(**CCFG)
    fault = TWireFault(drop_rate=0.15, corrupt_rate=0.15, seed=7)
    msgs = torch.from_numpy(U.stack(U.payload((3, 4, 32), 7)))
    runs = {}
    for where in ("cpu", "cuda"):
        dp = TDataplane(TCfg(mode="socket", emulate_costs=True),
                        mesh=make_mesh((2,), ("rank",)), device=where)
        conn = tverbs.conn_init(cfg, 3, device=where)
        conn, rt = tverbs.srq_post(dp, cfg, conn, dst=1, n=12,
                                   state=dp.runtime_init())
        out, conn, rt = tverbs.conn_send(dp, cfg, conn, msgs.to(where), 0, 1,
                                         state=rt, fault=fault)
        st = tverbs.allreduce_state(rt)
        runs[where] = (out.cpu().numpy(), tverbs.conn_snapshot(conn),
                       {"counters": st["counters"].cpu().numpy()})
    U.assert_same(runs["cpu"], runs["cuda"])
    np.testing.assert_array_equal(runs["cuda"][0][1], msgs[0].numpy())
