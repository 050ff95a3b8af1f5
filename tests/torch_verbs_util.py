"""Shared runners for the verbs-transport parity tests
(tests/test_torch_verbs*.py, test_torch_transport.py, test_torch_conn.py).

``repro`` runs each transfer as its own tests do, inside ``shard_map`` on
the 2-device ``("rank",)`` mesh (``tests/test_transport.py``); the port
runs the same transfer on rank-stacked tensors on the CPU.  Both return
the receiving rank's payloads, the QP or table as a ``*_snapshot`` (one
layout in both packages) and the aggregated runtime report.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core import verbs as jverbs
from repro.core.dataplane import Dataplane as JDataplane

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core import verbs as tverbs
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh


def dataplanes(mesh2, mode="cord", *, jpolicies=None, tpolicies=None,
               **kw):
    """The same dataplane in both packages; ``kw`` are DataplaneConfig
    fields and Dataplane keywords (tenant, tenants)."""
    dp_kw = {k: kw.pop(k) for k in ("tenant", "tenants") if k in kw}
    jdp = JDataplane(JCfg(mode=mode, **kw), mesh=mesh2, policies=jpolicies,
                     **dp_kw)
    tdp = TDataplane(TCfg(mode=mode, **kw), mesh=make_mesh((2,), ("rank",)),
                     policies=tpolicies, device="cpu", **dp_kw)
    return jdp, tdp


def payload(shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def stack(p, other=None) -> np.ndarray:
    """(2, ...): rank 0 holds ``p``, rank 1 ``other`` (zeros)."""
    return np.stack([p, np.zeros_like(p) if other is None else other])


# ---------------------------------------------------------------------------
# single QP: windowed_send
# ---------------------------------------------------------------------------

def jax_windowed(mesh2, dp, cfg, msgs, *, op="send", credits=None,
                 fault=None, with_state=True, dp_peer=None):
    n = msgs.shape[1]
    credits = n if credits is None else credits

    def body(m, rt):
        rank = jax.lax.axis_index("rank")
        qp = jverbs.qp_init(cfg)
        if op == "send" and credits:
            qp, rt = jverbs.post_recv(dp_peer or dp, cfg, qp, rank, dst=1,
                                      n=credits, state=rt)
        out, qp, rt = jverbs.windowed_send(dp, cfg, qp, m[0], rank, src=0,
                                           dst=1, op=op, state=rt,
                                           dp_peer=dp_peer, fault=fault)
        return out[None], qp, jverbs.allreduce_state(rt)

    fn = jax.jit(compat.shard_map(
        body, mesh=mesh2, in_specs=(P("rank", None, None), P()),
        out_specs=(P("rank", None, None), jverbs.qp_specs("rank"), P())))
    out, qp, rt = jax.block_until_ready(
        fn(jnp.asarray(msgs), dp.runtime_init() if with_state else None))
    return np.asarray(out), jverbs.qp_snapshot(qp), state_np(rt)


def torch_windowed(dp, cfg, msgs, *, op="send", credits=None, fault=None,
                   with_state=True, dp_peer=None):
    import torch
    n = msgs.shape[1]
    credits = n if credits is None else credits
    rt = dp.runtime_init() if with_state else None
    qp = tverbs.qp_init(cfg, device=dp.device)
    if op == "send" and credits:
        qp, rt = tverbs.post_recv(dp_peer or dp, cfg, qp, dst=1, n=credits,
                                  state=rt)
    out, qp, rt = tverbs.windowed_send(dp, cfg, qp,
                                       torch.from_numpy(msgs.copy()),
                                       src=0, dst=1, op=op, state=rt,
                                       dp_peer=dp_peer, fault=fault)
    return out.numpy(), tverbs.qp_snapshot(qp), \
        state_np(tverbs.allreduce_state(rt))


# ---------------------------------------------------------------------------
# connection table: conn_send
# ---------------------------------------------------------------------------

def jax_conn(mesh2, dp, cfg, msgs, *, tenants=None, fault=None,
             credits=None):
    Q, n = msgs.shape[1], msgs.shape[2]
    credits = Q * n if credits is None else credits

    def body(m, rt):
        rank = jax.lax.axis_index("rank")
        conn = jverbs.conn_init(cfg, Q)
        conn, rt = jverbs.srq_post(dp, cfg, conn, rank, dst=1, n=credits,
                                   state=rt)
        out, conn, rt = jverbs.conn_send(dp, cfg, conn, m[0], rank, src=0,
                                         dst=1, state=rt, tenants=tenants,
                                         fault=fault)
        return out[None], conn, jverbs.allreduce_state(rt)

    fn = jax.jit(compat.shard_map(
        body, mesh=mesh2, in_specs=(P("rank", None, None, None), P()),
        out_specs=(P("rank", None, None, None), jverbs.conn_specs(), P())))
    out, conn, rt = jax.block_until_ready(fn(jnp.asarray(msgs),
                                             dp.runtime_init()))
    return np.asarray(out), jverbs.conn_snapshot(conn), state_np(rt)


def torch_conn(dp, cfg, msgs, *, tenants=None, fault=None, credits=None):
    import torch
    Q, n = msgs.shape[1], msgs.shape[2]
    credits = Q * n if credits is None else credits
    conn = tverbs.conn_init(cfg, Q, device=dp.device)
    conn, rt = tverbs.srq_post(dp, cfg, conn, dst=1, n=credits,
                               state=dp.runtime_init())
    out, conn, rt = tverbs.conn_send(dp, cfg, conn,
                                     torch.from_numpy(msgs.copy()), src=0,
                                     dst=1, state=rt, tenants=tenants,
                                     fault=fault)
    return out.numpy(), tverbs.conn_snapshot(conn), \
        state_np(tverbs.allreduce_state(rt))


def state_np(state) -> dict | None:
    """An aggregated runtime state as flat numpy leaves ("counters",
    "qos/tokens", ...), from either package."""
    if state is None:
        return None
    out = {}
    for k, v in state.items():
        for name, leaf in (v.items() if isinstance(v, dict) else [("", v)]):
            key = f"{k}/{name}" if name else k
            out[key] = leaf.numpy() if hasattr(leaf, "numpy") and \
                not isinstance(leaf, np.ndarray) else np.asarray(leaf)
    return out


def report(dp, st: dict) -> dict:
    """``dp.runtime_report`` of a :func:`state_np` result."""
    from repro_torch.core import telemetry as tl
    return tl.tenant_counters_report(st["counters"], dp.tenants)


def assert_same_tree(t: dict, j: dict) -> None:
    """Equal keys, and every leaf equal in value, dtype and shape."""
    assert set(t) == set(j), (sorted(t), sorted(j))
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k


def assert_same(j, t) -> None:
    """Payloads, every snapshot key (values and dtypes) and the aggregated
    runtime state (counters, QoS tokens) equal, exactly."""
    (jo, js, jr), (to, ts, tr) = j, t
    np.testing.assert_array_equal(to, jo)
    assert_same_tree(ts, js)
    if jr is None or tr is None:
        assert jr is None and tr is None
    else:
        assert_same_tree(tr, jr)
