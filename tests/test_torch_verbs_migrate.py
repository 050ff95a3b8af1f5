"""Live migration across the two packages: a windowed transfer, and a
connection table, quiesced and snapshotted in ``repro`` finish in the
port, and the other way round; the quiesce routing of error, stale and
silently dropped WRs; the snapshot layout and restore's refusals.

``repro`` runs inside ``shard_map`` on the 2-device ``("rank",)`` mesh,
the port on rank-stacked tensors on the CPU, delay calibration pinned in
both.  Tolerance: exact — the combined delivery equals the payload bit
for bit, and the second half's delivery, final QP / table and runtime
state equal those of the same split run wholly in ``repro``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat
from repro.core import verbs as jverbs
from repro.runtime.fault import WireFault as JWireFault

from repro_torch.core import verbs as tverbs
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.fault import WireFault as TWireFault

import torch_verbs_util as U
from torch_port_util import pin_calibration

FAULT = dict(drop_rate=0.2, corrupt_rate=0.1, seed=13)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_calibration(monkeypatch)


# ---------------------------------------------------------------------------
# the pieces of a migratable transfer, in each package
# ---------------------------------------------------------------------------

def _jax_parts(mesh2, dp, cfg, *, table: int = 0, credits=0, fault=None):
    """init / xfer / quiesce of a QP (``table == 0``) or of a table of
    ``table`` QPs, as repro's tests jit them."""
    spec = jverbs.conn_specs() if table else jverbs.qp_specs("rank")
    mspec = P("rank", None, None, None) if table else P("rank", None, None)

    def init_body(rt):
        rank = jax.lax.axis_index("rank")
        if table:
            c = jverbs.conn_init(cfg, table)
            if credits:
                c, rt = jverbs.srq_post(dp, cfg, c, rank, dst=1, n=credits,
                                        state=rt)
        else:
            c = jverbs.qp_init(cfg)
            if credits:
                c, rt = jverbs.post_recv(dp, cfg, c, rank, dst=1, n=credits,
                                         state=rt)
        return c, jverbs.allreduce_state(rt)

    def xfer_body(m, c, rt):
        rank = jax.lax.axis_index("rank")
        send = jverbs.conn_send if table else jverbs.windowed_send
        out, c, rt = send(dp, cfg, c, m[0], rank, src=0, dst=1, state=rt,
                          fault=fault)
        return out[None], c, jverbs.allreduce_state(rt)

    def quiesce_body(c, rt):
        rank = jax.lax.axis_index("rank")
        q = jverbs.conn_quiesce if table else jverbs.qp_quiesce
        c, rt = q(dp, cfg, c, rank, src=0, state=rt)
        return c, jverbs.allreduce_state(rt)

    sm = lambda f, i, o: jax.jit(compat.shard_map(f, mesh=mesh2,  # noqa
                                                  in_specs=i, out_specs=o))
    return {"init": sm(init_body, (P(),), (spec, P())),
            "xfer": sm(xfer_body, (mspec, spec, P()), (mspec, spec, P())),
            "quiesce": sm(quiesce_body, (spec, P()), (spec, P())),
            "snapshot": jverbs.conn_snapshot if table else jverbs.qp_snapshot,
            "restore": lambda s: (jverbs.conn_restore if table
                                  else jverbs.qp_restore)(s, mesh2)}


def _torch_parts(dp, cfg, *, table: int = 0, credits=0, fault=None):
    def init(rt):
        if table:
            c = tverbs.conn_init(cfg, table, device="cpu")
            if credits:
                c, rt = tverbs.srq_post(dp, cfg, c, dst=1, n=credits,
                                        state=rt)
        else:
            c = tverbs.qp_init(cfg, device="cpu")
            if credits:
                c, rt = tverbs.post_recv(dp, cfg, c, dst=1, n=credits,
                                         state=rt)
        return c, rt

    def xfer(m, c, rt):
        send = tverbs.conn_send if table else tverbs.windowed_send
        out, c, rt = send(dp, cfg, c, torch.from_numpy(np.asarray(m)),
                          src=0, dst=1, state=rt, fault=fault)
        return out.numpy(), c, tverbs.allreduce_state(rt)

    def quiesce(c, rt):
        q = tverbs.conn_quiesce if table else tverbs.qp_quiesce
        c, rt = q(dp, cfg, c, src=0, state=rt)
        return c, tverbs.allreduce_state(rt)

    mesh = make_mesh((2,), ("rank",))
    return {"init": init, "xfer": xfer, "quiesce": quiesce,
            "snapshot": tverbs.conn_snapshot if table else tverbs.qp_snapshot,
            "restore": lambda s: (tverbs.conn_restore if table
                                  else tverbs.qp_restore)(s, mesh,
                                                          device="cpu")}


def _split(first, second, jdp, tdp, msgs, k, table):
    """Half the messages in ``first``, quiesce, snapshot, restore in
    ``second``, the rest there.  Returns (delivery of both halves, the
    final snapshot, the second half's runtime state)."""
    cut = (slice(None),) * (2 if table else 1)
    dp1 = jdp if first["is_jax"] else tdp
    dp2 = jdp if second["is_jax"] else tdp
    c, _ = first["init"](dp1.runtime_init())
    out1, c, _ = first["xfer"](msgs[cut + (slice(None, k),)], c,
                               dp1.runtime_init())
    c, _ = first["quiesce"](c, dp1.runtime_init())
    snap = first["snapshot"](c)
    assert int(snap["cq_head"] - snap["cq_tail"]) == 0
    np.testing.assert_array_equal(snap["sq_head"], snap["cq_sent"])
    c2 = second["restore"](snap)
    out2, c2, rt = second["xfer"](msgs[cut + (slice(k, None),)], c2,
                                  dp2.runtime_init())
    moved = np.concatenate([np.asarray(out1)[1], np.asarray(out2)[1]],
                           axis=1 if table else 0)
    return moved, np.asarray(out2), second["snapshot"](c2), U.state_np(rt)


@pytest.mark.parametrize("table", [0, 3])
@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
@pytest.mark.parametrize("fault", [None, FAULT])
def test_migration_across_packages(mesh2, table, direction, fault):
    if table:
        cfg_kw = dict(msg_bytes=32, depth=8, max_outstanding=3,
                      rto_ticks=4)
        payload = U.payload((table, 4, 32), 12)
        n, credits = 4, table * 4 * 2
    else:
        cfg_kw = dict(msg_bytes=64, depth=4, max_outstanding=4)
        payload = U.payload((8, 64), 13)
        n, credits = 8, 8 * 4
    msgs = U.stack(payload)
    jdp, tdp = U.dataplanes(mesh2, "cord", emulate_costs=True)
    jcfg, tcfg = jverbs.QPConfig(**cfg_kw), tverbs.QPConfig(**cfg_kw)
    jf = JWireFault(**fault) if fault else None
    tf = TWireFault(**fault) if fault else None
    kw = dict(table=table, credits=credits)
    j1 = {**_jax_parts(mesh2, jdp, jcfg, fault=jf, **kw), "is_jax": True}
    j2 = {**_jax_parts(mesh2, jdp, jcfg, fault=jf, table=table),
          "is_jax": True}
    t1 = {**_torch_parts(tdp, tcfg, fault=tf, **kw), "is_jax": False}
    t2 = {**_torch_parts(tdp, tcfg, fault=tf, table=table), "is_jax": False}
    k = n // 2
    ref = _split(j1, j2, jdp, tdp, msgs, k, table)      # wholly in repro
    got = _split(j1, t2, jdp, tdp, msgs, k, table) \
        if direction == "repro_to_port" else \
        _split(t1, j2, jdp, tdp, msgs, k, table)
    np.testing.assert_array_equal(got[0], payload)
    np.testing.assert_array_equal(ref[0], payload)
    np.testing.assert_array_equal(got[1], ref[1])
    U.assert_same_tree(got[2], ref[2])
    U.assert_same_tree(got[3], ref[3])


def test_snapshot_layout_is_repros(mesh2):
    """A port snapshot holds rank r's ring in rows r·depth on, as repro's
    global (post-shard_map) array does."""
    cfg = tverbs.QPConfig(msg_bytes=16, depth=4)
    qp = tverbs.qp_init(cfg, device="cpu")
    qp["send_ring"] = torch.from_numpy(U.payload((2, 4, 16), 3))
    snap = tverbs.qp_snapshot(qp)
    assert snap["send_ring"].shape == (8, 16)
    np.testing.assert_array_equal(snap["send_ring"][4:],
                                  qp["send_ring"][1].numpy())
    jq = jverbs.qp_restore(snap, mesh2)
    shards = sorted(jq["send_ring"].addressable_shards,
                    key=lambda s: s.index[0].start)
    np.testing.assert_array_equal(np.asarray(shards[1].data),
                                  qp["send_ring"][1].numpy())
    back = tverbs.qp_restore(jverbs.qp_snapshot(jq), device="cpu")
    np.testing.assert_array_equal(back["send_ring"].numpy(),
                                  qp["send_ring"].numpy())


def test_restore_refuses_what_repro_refuses(mesh2):
    ccfg = tverbs.QPConfig(msg_bytes=32, depth=8, max_outstanding=3)
    snap = tverbs.conn_snapshot(tverbs.conn_init(ccfg, 2, device="cpu"))
    del snap["cq_qp"]
    with pytest.raises(tverbs.TransportError):
        tverbs.conn_restore(snap, device="cpu")
    with pytest.raises(jverbs.TransportError):
        jverbs.conn_restore(snap, mesh2)
    qsnap = tverbs.qp_snapshot(tverbs.qp_init(ccfg, device="cpu"))
    del qsnap["credits"]
    with pytest.raises(tverbs.TransportError):
        tverbs.qp_restore(qsnap, device="cpu")
    qsnap = tverbs.qp_snapshot(tverbs.qp_init(ccfg, device="cpu"))
    qsnap["send_ring"] = qsnap["send_ring"][:-1]            # odd row count
    with pytest.raises(tverbs.TransportError):
        tverbs.qp_restore(qsnap, device="cpu")


def test_conn_quiesce_routes_error_stale_and_dropped(mesh2):
    """A hand-built table mid-retry, quiesced in both packages: the error
    CQE goes to its QP, the stale-epoch CQE is discarded, the silently
    dropped WRs land in rtx_pending; state equal to repro's."""
    cfg_kw = dict(msg_bytes=32, depth=8, max_outstanding=3)
    jdp, tdp = U.dataplanes(mesh2, "cord", emulate_costs=True)
    snap = tverbs.conn_snapshot(tverbs.conn_init(
        tverbs.QPConfig(**cfg_kw), 3, device="cpu"))
    snap["epoch"][0] = 2
    snap["cq_status"][0] = tverbs.CQE_ERR_RETRY
    snap["cq_wrid"][0] = snap["cq_sent"][1]
    snap["cq_qp"][0] = 1
    snap["cq_epoch"][0] = snap["epoch"][1]
    snap["cq_status"][1] = tverbs.CQE_SEND
    snap["cq_wrid"][1] = 5
    snap["cq_qp"][1] = 0
    snap["cq_epoch"][1] = 1                      # != epoch[0] == 2: stale
    snap["cq_head"] = np.asarray(2, np.int32)
    snap["sq_head"][2] = snap["cq_sent"][2] + 2  # dropped in flight
    snap["retry_cnt"][1] = 3
    snap["backoff"][1] = 1
    jp = _jax_parts(mesh2, jdp, jverbs.QPConfig(**cfg_kw), table=3)
    tp = _torch_parts(tdp, tverbs.QPConfig(**cfg_kw), table=3)
    jc, jrt = jp["quiesce"](jp["restore"](snap), jdp.runtime_init())
    tc, trt = tp["quiesce"](tp["restore"](snap), tdp.runtime_init())
    q = tverbs.conn_snapshot(tc)
    U.assert_same_tree(q, jverbs.conn_snapshot(jc))
    U.assert_same_tree(U.state_np(trt), U.state_np(jrt))
    np.testing.assert_array_equal(q["rtx_pending"], [0, 1, 2])
    assert q["retry_cnt"][1] == 3 and q["backoff"][1] == 1


def test_qp_quiesce_routes_like_repro(mesh2):
    """A QP with an error CQE, an in-order ack, a gap and a dropped WR."""
    cfg_kw = dict(msg_bytes=16, depth=8, max_outstanding=8)
    jdp, tdp = U.dataplanes(mesh2, "socket", emulate_costs=True)
    snap = tverbs.qp_snapshot(tverbs.qp_init(tverbs.QPConfig(**cfg_kw),
                                             device="cpu"))
    snap["cq_status"][:3] = [tverbs.CQE_SEND, tverbs.CQE_ERR_RETRY,
                             tverbs.CQE_SEND]
    snap["cq_wrid"][:3] = [0, 1, 3]
    snap["cq_head"] = np.asarray(3, np.int32)
    snap["sq_head"] = np.asarray(5, np.int32)
    jp = _jax_parts(mesh2, jdp, jverbs.QPConfig(**cfg_kw))
    tp = _torch_parts(tdp, tverbs.QPConfig(**cfg_kw))
    jq, jrt = jp["quiesce"](jp["restore"](snap), jdp.runtime_init())
    tq, trt = tp["quiesce"](tp["restore"](snap), tdp.runtime_init())
    U.assert_same_tree(tverbs.qp_snapshot(tq), jverbs.qp_snapshot(jq))
    U.assert_same_tree(U.state_np(trt), U.state_np(jrt))
    # the error and the gap, then 4 in flight past the one ack
    assert tq["rtx_pending"] == 2 + 4 and tq["cq_sent"] == 1
