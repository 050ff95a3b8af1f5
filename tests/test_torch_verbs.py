"""Port parity for the verbs transport's synchronous path and lossless
``windowed_send``: QP layout and config checks, ``rank_mediate`` /
``rank_complete``, ``post_send`` / ``flush_send`` / ``poll_cq`` with one
runtime state per rank, ``allreduce_state``, and the sender window with
credit flow control (RC send / write / read, UD send) in bypass, cord and
socket mode.

``repro`` runs inside ``shard_map`` on the 2-device ``("rank",)`` mesh;
the port on rank-stacked tensors on the CPU, delay calibration pinned in
both.  Tolerance: exact — payloads bit for bit, every QP key (value,
dtype, shape) and the aggregated runtime state (every counter, QoS
tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat
from repro.core import verbs as jverbs

from repro_torch.core import techniques as ttech
from repro_torch.core import verbs as tverbs
from repro_torch.kernels.dataplane import bounce as tbounce

import torch_verbs_util as U
from torch_port_util import PROBE_ITERS, cuda_device, pin_calibration


@pytest.fixture(autouse=True)
def _pinned(monkeypatch, request):
    # a card test pins the port's slopes itself: the card has no JAX
    if request.node.get_closest_marker("cuda") is None:
        pin_calibration(monkeypatch)


def _cfgs(**kw):
    return jverbs.QPConfig(**kw), tverbs.QPConfig(**kw)


def test_qp_init_layout_is_repros(mesh2):
    jcfg, tcfg = _cfgs(msg_bytes=64, depth=4, max_outstanding=6)
    fn = jax.jit(compat.shard_map(lambda: jverbs.qp_init(jcfg), mesh=mesh2,
                                  in_specs=(),
                                  out_specs=jverbs.qp_specs("rank")))
    j = jverbs.qp_snapshot(fn())
    t = tverbs.qp_snapshot(tverbs.qp_init(tcfg, device="cpu"))
    U.assert_same_tree(t, j)
    assert set(tverbs.qp_specs()) == set(jverbs.qp_specs())


@pytest.mark.parametrize("kw", [
    dict(transport="XX"), dict(transport="UD", msg_bytes=8192),
    dict(depth=0), dict(max_outstanding=0), dict(retry_limit=-1),
    dict(rto_ticks=0), dict(backoff_ticks=-1),
    dict(msg_bytes=6, dtype="int32"), dict(msg_bytes=2, dtype="float32")])
def test_qpconfig_rejects_what_repro_rejects(kw):
    with pytest.raises(jverbs.TransportError):
        jverbs.QPConfig(**kw)
    with pytest.raises(tverbs.TransportError):
        tverbs.QPConfig(**kw)


def test_qp_init_rejects_ragged_dtype():
    cfg = tverbs.QPConfig(msg_bytes=6)
    with pytest.raises(tverbs.TransportError):
        tverbs.qp_init(cfg, dtype="float32", device="cpu")
    assert tverbs.QPConfig(msg_bytes=8).effective_cq_depth == 16


@pytest.mark.parametrize("mode", ["bypass", "cord", "socket"])
def test_sync_path_per_rank_states(mesh2, mode):
    """post_send × n → flush_send → poll_cq: each rank's pipeline bumps
    its own state (flush is one mediated ppermute, both ranks), and the
    folded report equals repro's psum of its two ranks' states."""
    n = 5
    jcfg, tcfg = _cfgs(msg_bytes=32, depth=8)
    jdp, tdp = U.dataplanes(mesh2, mode, emulate_costs=True)
    msgs = U.stack(U.payload((n, 32), 3), U.payload((n, 32), 4))

    def body(m, rt):
        rank = jax.lax.axis_index("rank")
        qp = jverbs.qp_init(jcfg)
        for i in range(n):
            qp, rt = jverbs.post_send(jdp, jcfg, qp, m[0, i], rank, src=0,
                                      state=rt)
        qp, rt = jverbs.flush_send(jdp, jcfg, qp, rank, src=0, dst=1,
                                   state=rt)
        done, qp, rt = jverbs.poll_cq(jdp, jcfg, qp, rank, poller=1,
                                      state=rt)
        return qp, done, jverbs.allreduce_state(rt)

    fn = jax.jit(compat.shard_map(
        body, mesh=mesh2, in_specs=(P("rank", None, None), P()),
        out_specs=(jverbs.qp_specs("rank"), P(), P())))
    jqp, jdone, jrt = fn(jnp.asarray(msgs), jdp.runtime_init())

    tm = torch.from_numpy(msgs)
    qp, rt = tverbs.qp_init(tcfg, device="cpu"), tdp.runtime_init()
    for i in range(n):
        qp, rt = tverbs.post_send(tdp, tcfg, qp, tm[:, i], src=0, state=rt)
    qp, rt = tverbs.flush_send(tdp, tcfg, qp, src=0, dst=1, state=rt)
    assert isinstance(rt, list) and len(rt) == 2
    done, qp, rt = tverbs.poll_cq(tdp, tcfg, qp, poller=1, state=rt)
    assert done == int(jdone) == n
    U.assert_same_tree(tverbs.qp_snapshot(qp), jverbs.qp_snapshot(jqp))
    U.assert_same_tree(U.state_np(tverbs.allreduce_state(rt)),
                       U.state_np(jrt))
    # the receiver's ring holds the sender's posts
    np.testing.assert_array_equal(qp["recv_ring"][1, :n].numpy(), msgs[0])


def test_flush_read_moves_remote_memory_without_completions(mesh2):
    tcfg = tverbs.QPConfig(msg_bytes=16, depth=4)
    _, tdp = U.dataplanes(mesh2, "cord")
    qp = tverbs.qp_init(tcfg, device="cpu")
    remote = torch.from_numpy(U.payload((4, 16), 5))
    qp["recv_ring"][1] = remote
    qp2, _ = tverbs.flush_send(tdp, tcfg, qp, src=0, dst=1, op="read")
    np.testing.assert_array_equal(qp2["send_ring"][0].numpy(), remote)
    assert tverbs.cq_occupancy(qp2) == 0 and qp2["cq_sent"] == 0
    with pytest.raises(tverbs.TransportError):
        tverbs.flush_send(tdp, tverbs.QPConfig(transport="UD",
                                               msg_bytes=16),
                          qp, src=0, dst=1, op="write")


@pytest.mark.parametrize("side", ["mediate", "complete"])
def test_rank_side_runs_on_the_active_slice_only(mesh2, side):
    """The pipeline runs once, on the active slice and its state; the
    other slice passes through, bit for bit, and its state untouched."""
    _, tdp = U.dataplanes(mesh2, "socket", emulate_costs=True)
    x = torch.from_numpy(U.payload((2, 64), 6))
    fn = tverbs.rank_mediate if side == "mediate" else tverbs.rank_complete
    rt = tdp.runtime_init()
    y, states = fn(x, 1, tdp, state=rt)
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    assert states[0] is rt and states[1] is not rt
    yl, _ = fn(list(x), 1, tdp)
    assert isinstance(yl, list) and yl[0] is not None
    np.testing.assert_array_equal(torch.stack(yl).numpy(), x.numpy())


def test_allreduce_state_sums_ranks_and_peaks_cq_depth(mesh2):
    """Every leaf summed over ranks (QoS tokens included, as repro's
    psum); ``cq_depth`` the max."""
    from repro_torch.core import policies as tpol
    from repro_torch.core import telemetry as tl
    _, tdp = U.dataplanes(mesh2, "cord", tenants=("a", "b"),
                          tpolicies=[tpol.QoSPolicy(rates={"a": 0.5})])
    s0, s1 = tdp.runtime_init(), tdp.runtime_init()
    s0 = {**s0, "counters": tl.tenant_counters_peak(
        tl.tenant_counters_bump(s0["counters"], 0, ops=2), 0, cq_depth=3)}
    s1 = {**s1, "counters": tl.tenant_counters_peak(
        tl.tenant_counters_bump(s1["counters"], 0, ops=5), 0, cq_depth=7)}
    out = tverbs.allreduce_state([s0, s1])
    rep = tdp.runtime_report(out)["default"]
    assert rep["ops"] == 7.0 and rep["cq_depth"] == 7.0
    np.testing.assert_array_equal(out["qos"]["tokens"].numpy(),
                                  [8.0, 8.0, 8.0])
    assert tverbs.allreduce_state(None) is None


WINDOWED = [  # (mode, transport, op, credits, window, n)
    ("cord", "RC", "send", None, 4, 7),
    ("cord", "RC", "send", 2, 4, 7),        # credit-starved: stalls
    ("cord", "RC", "write", None, 3, 6),
    ("cord", "RC", "read", None, 4, 7),
    ("cord", "UD", "send", None, 4, 7),
    ("cord", "UD", "send", 3, 2, 6),
    ("socket", "RC", "send", 2, 4, 5),
    ("socket", "RC", "read", None, 2, 5),
    ("bypass", "RC", "send", None, 4, 7),
    ("bypass", "RC", "write", None, 1, 4),
]


@pytest.mark.parametrize("mode, transport, op, credits, window, n", WINDOWED)
def test_windowed_lossless_matches_repro(mesh2, mode, transport, op, credits,
                                         window, n):
    jcfg, tcfg = _cfgs(transport=transport, msg_bytes=64, depth=4,
                       max_outstanding=window)
    jdp, tdp = U.dataplanes(mesh2, mode, emulate_costs=True)
    src_mem = U.payload((n, 64), 1)
    msgs = U.stack(src_mem, U.payload((n, 64), 2))
    j = U.jax_windowed(mesh2, jdp, jcfg, msgs, op=op, credits=credits)
    t = U.torch_windowed(tdp, tcfg, msgs, op=op, credits=credits)
    U.assert_same(j, t)
    recv = 0 if op == "read" else 1
    np.testing.assert_array_equal(t[0][recv], msgs[1 - recv])
    if credits is not None and credits < n:
        assert U.report(tdp, t[2])["default"]["stalls"] > 0


def test_windowed_without_state_and_cq_window(mesh2):
    """No runtime state; a CQ smaller than the window caps it."""
    jcfg, tcfg = _cfgs(msg_bytes=16, depth=8, max_outstanding=6, cq_depth=3)
    jdp, tdp = U.dataplanes(mesh2, "cord")
    msgs = U.stack(U.payload((9, 16), 3))
    j = U.jax_windowed(mesh2, jdp, jcfg, msgs, with_state=False)
    t = U.torch_windowed(tdp, tcfg, msgs, with_state=False)
    U.assert_same(j, t)
    assert t[1]["win_hwm"] == 3


def test_windowed_rejects_bad_ops():
    _, tcfg = _cfgs(transport="UD", msg_bytes=16)
    msgs = torch.zeros((2, 2, 16), dtype=torch.uint8)
    qp = tverbs.qp_init(tcfg, device="cpu")
    for op in ("write", "read", "atomic"):
        with pytest.raises(tverbs.TransportError):
            tverbs.windowed_send(None, tcfg, qp, msgs, 0, 1, op=op)
    out, qp2, st = tverbs.windowed_send(None, tcfg, qp, msgs[:, :0], 0, 1)
    assert out.shape == (2, 0, 16) and qp2 is qp and st is None


@pytest.mark.cuda
def test_card_windowed_matches_cpu_and_never_syncs(monkeypatch):
    """The same windowed RC send on the card and on the CPU: bit-identical
    delivery, equal QP and report; one bounce launch per mediated post
    (cord's completion side is free) and no stream sync in the loop."""
    cuda_device()
    for kind in ("cpu", "cuda"):
        monkeypatch.setitem(ttech._CALIBRATION, (kind, PROBE_ITERS), 1.0)
    from repro_torch.configs.base import DataplaneConfig as TCfg
    from repro_torch.core.dataplane import Dataplane as TDataplane
    from repro_torch.launch.mesh import make_mesh
    n, cfg = 24, tverbs.QPConfig(msg_bytes=4096, depth=8, max_outstanding=8)
    msgs = torch.from_numpy(U.stack(U.payload((n, 4096), 7)))
    outs = {}
    for where in ("cpu", "cuda"):
        dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                        mesh=make_mesh((2,), ("rank",)), device=where)
        qp, rt = tverbs.post_recv(dp, cfg, tverbs.qp_init(cfg, device=where),
                                  dst=1, n=n, state=dp.runtime_init())
        m = msgs.to(where)
        if where == "cuda":
            torch.cuda.synchronize()
            n0 = tbounce.LAUNCHES
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, qp, rt = tverbs.windowed_send(dp, cfg, qp, m, 0, 1,
                                               state=rt)
        finally:
            if where == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        if where == "cuda":
            torch.cuda.synchronize()
            assert tbounce.LAUNCHES - n0 == n
        outs[where] = (out.cpu().numpy(), tverbs.qp_snapshot(qp),
                       U.state_np({k: v.cpu() if torch.is_tensor(v) else
                                   {a: b.cpu() for a, b in v.items()}
                                   for k, v in
                                   tverbs.allreduce_state(rt).items()}))
    U.assert_same(outs["cpu"], outs["cuda"])
    np.testing.assert_array_equal(outs["cuda"][0][1], msgs[0].numpy())
