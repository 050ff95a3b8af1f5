"""Port parity for the go-back-N retransmission machine of
``windowed_send`` under ``WireFault`` (drops caught by a sequence gap or
the RTO, corruption NAKs, random loss, retry exhaustion turning the QP
fatal), ``cq_shed`` on a CQ-ring overrun, and ``adaptive_rto``.

``repro`` runs inside ``shard_map`` on the 2-device ``("rank",)`` mesh,
the port on rank-stacked tensors on the CPU, delay calibration pinned in
both.  Tolerance: exact — payloads bit for bit, every QP key and the
aggregated runtime state; ``adaptive_rto`` value for value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat
from repro.core import verbs as jverbs
from repro.runtime.fault import WireFault as JWireFault

from repro_torch.core import verbs as tverbs
from repro_torch.runtime.fault import WireFault as TWireFault

import torch_verbs_util as U
from torch_port_util import pin_calibration

CFG = dict(msg_bytes=64, depth=8, max_outstanding=4, retry_limit=7,
           rto_ticks=4, backoff_ticks=1)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch, request):
    # a card test pins the port's slopes itself: the card has no JAX
    if request.node.get_closest_marker("cuda") is None:
        pin_calibration(monkeypatch)


def _both(mesh2, cfg_kw, msgs, fault_kw, *, mode="cord", op="send",
          emulate=True, credits=None):
    jdp, tdp = U.dataplanes(mesh2, mode, emulate_costs=emulate)
    jcfg, tcfg = jverbs.QPConfig(**cfg_kw), tverbs.QPConfig(**cfg_kw)
    j = U.jax_windowed(mesh2, jdp, jcfg, msgs, op=op, credits=credits,
                       fault=JWireFault(**fault_kw))
    t = U.torch_windowed(tdp, tcfg, msgs, op=op, credits=credits,
                         fault=TWireFault(**fault_kw))
    U.assert_same(j, t)
    return t, U.report(tdp, t[2])["default"]


FAULTS = [
    ("drop_mid", dict(drops=((2, 0),))),            # gap-detected rewind
    ("drop_last", dict(drops=((5, 0),))),           # RTO-detected rewind
    ("corrupt", dict(corrupts=((1, 0),))),          # NAK (CQE_ERR_RETRY)
    ("rates", dict(drop_rate=0.2, corrupt_rate=0.2, seed=3)),
    ("never_fires", dict(drops=((99, 99),))),       # armed, lossless
]


@pytest.mark.parametrize("kind, fault_kw", FAULTS)
@pytest.mark.parametrize("op", ["send", "write", "read"])
def test_lossy_windowed_matches_repro(mesh2, kind, fault_kw, op):
    payload = U.payload((6, 64), 2)
    msgs = U.stack(payload, U.payload((6, 64), 12))
    (out, qp, _), rep = _both(mesh2, CFG, msgs, fault_kw, op=op)
    recv = 0 if op == "read" else 1
    np.testing.assert_array_equal(out[recv], msgs[1 - recv])
    assert int(qp["retry_cnt"]) == 0
    if kind == "never_fires":
        assert rep["retransmits"] == 0 and rep["timeouts"] == 0
    else:
        assert rep["retransmits"] > 0
    if kind == "drop_last":
        assert rep["timeouts"] > 0


@pytest.mark.parametrize("mode, emulate, credits", [
    ("socket", True, 3), ("bypass", True, None), ("cord", False, 2)])
def test_lossy_windowed_modes_and_credits(mesh2, mode, emulate, credits):
    msgs = U.stack(U.payload((7, 64), 5))
    fault = dict(drop_rate=0.25, corrupt_rate=0.1, seed=11)
    (out, _, _), _ = _both(mesh2, CFG, msgs, fault, mode=mode,
                           emulate=emulate, credits=credits)
    np.testing.assert_array_equal(out[1], msgs[0])


def test_retry_exhaustion_turns_fatal(mesh2):
    """100 % loss: the QP retries ``retry_limit`` times, turns fatal
    instead of hanging, and undelivered slots stay zero."""
    cfg = dict(msg_bytes=64, depth=8, max_outstanding=4, retry_limit=2,
               rto_ticks=3, backoff_ticks=1)
    msgs = U.stack(U.payload((4, 64), 3))
    (out, qp, _), rep = _both(mesh2, cfg, msgs, dict(drop_rate=1.0))
    assert int(qp["retry_cnt"]) > cfg["retry_limit"]
    np.testing.assert_array_equal(out[1], np.zeros_like(msgs[0]))
    assert rep["timeouts"] >= cfg["retry_limit"] + 1


def test_adaptive_rto_off_matches_repro(mesh2):
    cfg = dict(CFG, adaptive_rto=False)
    msgs = U.stack(U.payload((6, 64), 11))
    (out, _, _), _ = _both(mesh2, cfg, msgs, dict(drop_rate=0.3, seed=7))
    np.testing.assert_array_equal(out[1], msgs[0])


def test_cq_shed_lands_in_telemetry(mesh2):
    """6 CQEs flushed into a 2-slot ring: 4 shed, on the QP and in the
    sender's counter block."""
    jcfg = jverbs.QPConfig(msg_bytes=16, depth=8, cq_depth=2)
    tcfg = tverbs.QPConfig(msg_bytes=16, depth=8, cq_depth=2)
    jdp, tdp = U.dataplanes(mesh2, "cord")
    msgs = U.stack(U.payload((6, 16), 5))

    def body(m, rt):
        rank = jax.lax.axis_index("rank")
        qp = jverbs.qp_init(jcfg)
        for i in range(6):
            qp, rt = jverbs.post_send(jdp, jcfg, qp, m[0, i], rank, src=0,
                                      state=rt)
        qp, rt = jverbs.flush_send(jdp, jcfg, qp, rank, src=0, dst=1,
                                   state=rt)
        return qp, jverbs.allreduce_state(rt)

    fn = jax.jit(compat.shard_map(
        body, mesh=mesh2, in_specs=(P("rank", None, None), P()),
        out_specs=(jverbs.qp_specs("rank"), P())))
    jqp, jrt = fn(jnp.asarray(msgs), jdp.runtime_init())

    tm = torch.from_numpy(msgs)
    qp, rt = tverbs.qp_init(tcfg, device="cpu"), tdp.runtime_init()
    for i in range(6):
        qp, rt = tverbs.post_send(tdp, tcfg, qp, tm[:, i], src=0, state=rt)
    qp, rt = tverbs.flush_send(tdp, tcfg, qp, src=0, dst=1, state=rt)
    st = U.state_np(tverbs.allreduce_state(rt))
    U.assert_same_tree(tverbs.qp_snapshot(qp), jverbs.qp_snapshot(jqp))
    U.assert_same_tree(st, U.state_np(jrt))
    assert qp["cq_shed"] == 4
    assert U.report(tdp, st)["default"]["cq_shed"] == 4.0


def test_adaptive_rto_equals_repro():
    cfg_j, cfg_t = jverbs.QPConfig(rto_ticks=8), tverbs.QPConfig(rto_ticks=8)
    srtt = np.array([0.0, 0.5, 1.0, 1.5, 3.0, 3.5, 50.0, 100.0, 0.125],
                    np.float32)
    for nsamp in (np.zeros(9, np.int32), np.arange(9, dtype=np.int32),
                  np.full(9, 3, np.int32)):
        want = np.asarray(jverbs.adaptive_rto(jnp.asarray(srtt),
                                              jnp.asarray(nsamp), cfg_j))
        got = tverbs.adaptive_rto(srtt, nsamp, cfg_t)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert int(tverbs.adaptive_rto(np.float32(1.0), 2, cfg_t)) == 3
    assert int(tverbs.adaptive_rto(np.float32(0.0), 0, cfg_t)) == 8


@pytest.mark.cuda
def test_card_lossy_windowed_matches_cpu(monkeypatch):
    """A lossy windowed RC send on the card and on the CPU: the same
    delivery, QP and report, and one bounce launch per delay chain the
    CPU run takes (each mediated post, stall and backoff tick)."""
    from repro_torch.configs.base import DataplaneConfig as TCfg
    from repro_torch.core import techniques as ttech
    from repro_torch.core.dataplane import Dataplane as TDataplane
    from repro_torch.kernels.dataplane import bounce as tbounce
    from repro_torch.launch.mesh import make_mesh
    from torch_port_util import PROBE_ITERS, cuda_device
    cuda_device()
    for kind in ("cpu", "cuda"):
        monkeypatch.setitem(ttech._CALIBRATION, (kind, PROBE_ITERS), 1.0)
    cfg = tverbs.QPConfig(**CFG)
    fault = TWireFault(drop_rate=0.2, corrupt_rate=0.1, seed=5)
    msgs = torch.from_numpy(U.stack(U.payload((16, 64), 8)))
    chains, plain_chain = [0], ttech.delay_chain

    def counting_chain(x, iters):
        chains[0] += iters > 0
        return plain_chain(x, iters)

    runs, launches = {}, 0
    for where in ("cpu", "cuda"):
        dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                        mesh=make_mesh((2,), ("rank",)), device=where)
        with monkeypatch.context() as m:
            if where == "cpu":
                m.setattr(ttech, "delay_chain", counting_chain)
            n0 = tbounce.LAUNCHES
            qp, rt = tverbs.post_recv(dp, cfg,
                                      tverbs.qp_init(cfg, device=where),
                                      dst=1, n=16, state=dp.runtime_init())
            out, qp, rt = tverbs.windowed_send(dp, cfg, qp, msgs.to(where),
                                               0, 1, state=rt, fault=fault)
            launches = tbounce.LAUNCHES - n0
        st = tverbs.allreduce_state(rt)
        runs[where] = (out.cpu().numpy(), tverbs.qp_snapshot(qp),
                       {"counters": st["counters"].cpu().numpy()})
    U.assert_same(runs["cpu"], runs["cuda"])
    np.testing.assert_array_equal(runs["cuda"][0][1], msgs[0].numpy())
    assert launches == chains[0] > 16
