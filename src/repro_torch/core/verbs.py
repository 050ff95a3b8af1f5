"""ibverbs-style point-to-point layer: the "narrow waist" (paper §4) the
perftest reproduction runs on, the port of ``repro.core.verbs``.

* **Queue pairs** are ring buffers of fixed-size message slots (the
  registered memory the NIC reads from and writes to).
* **post_send / post_recv** enqueue work requests.  In ``cord`` /
  ``socket`` mode each post crosses the mediation layer (the syscall); in
  ``bypass`` it is a bare ring write.  ``post_recv`` is also the credit
  grant of the flow-control protocol.
* **flush_send** is the NIC DMA: one mediated ``Dataplane.ppermute`` of
  the ring over the ranks.
* **the completion queue** is a ring of per-entry status / wr_id records:
  the NIC pushes CQEs at ``cq_head``, software consumes them at
  ``cq_tail``; ``poll_cq`` drains it.
* **windowed_send** drives a sender window of up to ``max_outstanding``
  WRs in flight with credit flow control, one event per tick; armed with
  a :class:`~repro_torch.runtime.fault.WireFault` it runs the go-back-N
  retransmission machine, and a lossy transfer completes bit-identically
  to a lossless one.
* **the connection table** (``conn_init`` / ``conn_send``) multiplexes
  many QPs onto one shared CQ and one shared receive queue, with post
  order arbitrated by the QoS token buckets.
* **live migration** (MigrOS): ``qp_quiesce`` / ``conn_quiesce`` drain to
  an empty CQ, ``*_snapshot`` copies the state to host memory in
  ``repro``'s layout and ``*_restore`` puts it back, so a transfer
  stopped in one package finishes in the other.

**Layout.**  The ranks of the ``("rank",)`` mesh are a leading tensor
dim on the one card (``launch/mesh.py``), as in the port's collectives:
payloads and rings are rank-stacked (``msgs`` ``(R, n, slot)``, a QP's
rings ``(R, depth, slot)``, a table's ``(R, Q, depth, slot)``) on the
dataplane's device.  What ``repro`` keeps SPMD-uniform, the connection
state (cursors, the CQ ring, credits, the retry machine, the per-QP
vectors), is one copy, and it is host memory here, as a verbs driver
keeps its queue indices: Python ints and numpy int32 arrays.  The
runtime state is one per rank (each endpoint's pipeline bumps its own),
a list of R states, until :func:`allreduce_state` folds it; a single
state passed in is every rank's starting state, as ``repro``'s
replicated ``P()`` input.  ``rank`` leaves the signatures: the
``src`` / ``dst`` / ``poller`` / ``active_rank`` arguments say which
slice each side runs on.

**The loops.**  ``repro``'s ``lax.while_loop`` s are host loops with the
same fuel bounds, so trip counts agree.  Their branch decisions read
only the connection state, which is on the host, so a tick reads
nothing back from the card; ``conn_send`` under a QoS policy is the
exception, with one read of the Q arbitration scores a tick.  A
mediated post runs the pipeline on the active rank's slice only (the
dataplane kernel launches once, not R times); the other slices pass
through.  The verbs layer's own counter bumps (credits, completions,
stalls, CQ depth, retransmits, timeouts, SRQ grants, CQE errors, sheds,
and ``conn_send``'s hand-paid ops and bytes) are summed on the host and
added to the states once at the end of a call (:class:`_Tally`); they
are columns no pipeline stage writes, so the result equals ``repro``'s
tick-by-tick adds while the sums are exact in float32 (below 2**24).
A wire transfer between ranks (``repro``'s raw ``ppermute``) is a copy
between slices on the card.

Transports: ``RC`` (send / recv and one-sided READ / WRITE) and ``UD``
(messages up to 4 KiB, send / recv only).  One-sided ops mediate only on
the active side and consume no receiver credits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import techniques as tech
from repro_torch.core import telemetry as tl
from repro_torch.core.dataplane import Dataplane
from repro_torch.core.policies import QoSPolicy, QuotaPolicy
from repro_torch.device import resolve_device

UD_MTU = 4096

# Completion-queue entry status codes.
CQE_EMPTY = 0      # unowned slot
CQE_SEND = 1       # send/write/read WR completed (sender-side CQE)
CQE_RECV = 2       # receive completed (delivered into a posted recv buffer)
CQE_ERR_RETRY = 3  # WR failed retryably (wire corruption NAK): re-post it
CQE_ERR_FATAL = 4  # retry budget exhausted: the WR is abandoned


class TransportError(Exception):
    pass


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a numpy-style name (``"uint8"``) or a dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise TransportError(f"unknown slot dtype {dtype!r}")
    return dt


@dataclass(frozen=True)
class QPConfig:
    transport: str = "RC"          # RC | UD
    msg_bytes: int = 4096
    depth: int = 16                # ring slots
    max_outstanding: int = 8       # sender window (WRs in flight)
    cq_depth: int = 0              # CQ ring entries; 0 = max(depth, window)
    dtype: str = "uint8"           # slot element type
    axis: str = "rank"
    # retransmission machine: a WR whose CQE comes back CQE_ERR_RETRY, or
    # that never completes within ``rto_ticks`` loop ticks, is re-posted
    # go-back-N after ``backoff_ticks`` of backoff, at most
    # ``retry_limit`` consecutive times before the QP turns fatal.
    retry_limit: int = 7
    rto_ticks: int = 8
    backoff_ticks: int = 1
    # re-arm the retransmission timer from an EWMA of the observed drain
    # latency (:func:`adaptive_rto`); ``rto_ticks`` stays the ceiling.
    adaptive_rto: bool = True

    def __post_init__(self):
        if self.transport not in ("RC", "UD"):
            raise TransportError(f"unknown transport {self.transport!r}")
        if self.transport == "UD" and self.msg_bytes > UD_MTU:
            raise TransportError(
                f"UD supports messages up to {UD_MTU} B, got {self.msg_bytes}")
        if self.depth < 1 or self.max_outstanding < 1:
            raise TransportError(
                f"depth/max_outstanding must be >= 1, got "
                f"{self.depth}/{self.max_outstanding}")
        if self.retry_limit < 0 or self.rto_ticks < 1 or self.backoff_ticks < 0:
            raise TransportError(
                f"need retry_limit >= 0, rto_ticks >= 1, backoff_ticks >= 0, "
                f"got {self.retry_limit}/{self.rto_ticks}/{self.backoff_ticks}")
        itemsize = _torch_dtype(self.dtype).itemsize
        if self.msg_bytes < itemsize or self.msg_bytes % itemsize:
            raise TransportError(
                f"msg_bytes={self.msg_bytes} is not a positive multiple of "
                f"dtype {self.dtype!r} itemsize ({itemsize} B) — ring slots "
                f"would silently truncate")

    @property
    def effective_cq_depth(self) -> int:
        return self.cq_depth or max(self.depth, self.max_outstanding)


def _slot_elems(cfg: QPConfig, dtype) -> tuple[torch.dtype, int]:
    dt = _torch_dtype(dtype if dtype is not None else cfg.dtype)
    if cfg.msg_bytes % dt.itemsize:
        raise TransportError(
            f"msg_bytes={cfg.msg_bytes} not a multiple of dtype "
            f"{tl.dtype_name(dt)!r} itemsize ({dt.itemsize} B)")
    return dt, cfg.msg_bytes // dt.itemsize


def qp_init(cfg: QPConfig, dtype=None, *, ranks: int = 2,
            device=None) -> dict:
    """Create QP state: rank-stacked send / recv rings on ``device`` (the
    card unless the caller asks for the CPU), and the connection state on
    the host: queue counters and the CQ ring (per-entry status + wr_id,
    producer / consumer cursors)."""
    dt, slot = _slot_elems(cfg, dtype)
    dev = resolve_device(device)
    D = cfg.effective_cq_depth
    return {
        "send_ring": torch.zeros((ranks, cfg.depth, slot), dtype=dt,
                                 device=dev),
        "recv_ring": torch.zeros((ranks, cfg.depth, slot), dtype=dt,
                                 device=dev),
        "sq_head": 0,        # posted sends
        "cq_sent": 0,        # completed (consumed) sends
        "cq_rcvd": 0,        # completed (polled) recvs
        # the completion queue proper
        "cq_status": np.zeros((D,), np.int32),
        "cq_wrid": np.full((D,), -1, np.int32),
        "cq_head": 0,        # CQEs produced (NIC side)
        "cq_tail": 0,        # CQEs consumed (software side)
        "cq_hwm": 0,         # CQ occupancy high-water mark
        # credit-based flow control
        "credits": 0,        # rx buffers granted via post_recv
        "rx_owed": 0,        # delivered recvs awaiting re-post
        "win_hwm": 0,        # max observed in-flight window
        # retransmission machine + CQ-overrun visibility
        "retry_cnt": 0,      # consecutive retries of the oldest WR
        "backoff": 0,        # remaining backoff ticks before re-post
        "rtx_pending": 0,    # WRs a quiesce found unacked (must re-post)
        "cq_shed": 0,        # CQEs shed on ring overrun (cumulative)
    }


def _work(state: dict, clone_rings: bool = False) -> dict:
    """A private copy of a QP or table to update in place during a call:
    the host arrays copied, the rings cloned once or shared."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone() if clone_rings else v
        elif isinstance(v, np.ndarray):
            out[k] = v.astype(np.int32, copy=True)
        else:
            out[k] = int(v)
    return out


# ---------------------------------------------------------------------------
# per-rank mediation: client and server may independently run bypass (BP)
# or CoRD (CD) — the paper's fig. 3 matrix.  Both sides' work is the
# dataplane's mediation pipeline, run on the active rank's slice only.
# ---------------------------------------------------------------------------

def _verbs_rec(dp: Dataplane, x: torch.Tensor, tag: str) -> tl.OpRecord:
    shape, dtype = tl.describe(x)
    return tl.OpRecord(kind="verbs", tag=tag, bytes=tl.nbytes(x),
                       axes=("rank",), shape=shape, dtype=dtype,
                       mode=dp.mode)


def _rank_states(state, ranks: int):
    """A new list of ``ranks`` per-rank runtime states (None stays None):
    one state is every rank's starting state."""
    if state is None:
        return None
    if isinstance(state, dict):
        return [state] * ranks
    states = list(state)
    if len(states) != ranks:
        raise TransportError(f"{len(states)} runtime states for {ranks} "
                             f"ranks")
    return states


def _side(dp: Dataplane, side: str, x: torch.Tensor, rank: int, tag: str,
          states, tenant):
    """``dp.pipeline``'s ``side`` ("send" or "complete") on one rank's
    slice ``x``, with that rank's state in ``states`` (updated in place);
    returns ``x``'s result, bit-identical."""
    rec = _verbs_rec(dp, x, tag)
    st = None if states is None else states[rank]
    y, st = getattr(dp.pipeline, side)(x, rec, st, dp.tenant_index(tenant))
    if states is not None:
        states[rank] = st
    return y


def _rank_apply(side: str, x, active_rank: int, dp, tag, state, tenant):
    states = _rank_states(state, len(x))
    xa = x[active_rank]
    y = _side(dp, side, xa, active_rank, tag, states, tenant)
    if y is xa:
        return x, states
    if isinstance(x, list):
        return [y if r == active_rank else s for r, s in enumerate(x)], states
    x = x.clone()
    x[active_rank] = y
    return x, states


def rank_mediate(x: torch.Tensor, active_rank: int, dp: Dataplane,
                 tag: str = "verbs/post", state=None,
                 tenant: str | None = None):
    """Apply ``dp.pipeline``'s issue-side stages to slice ``active_rank``
    of ``x`` only: a rank-stacked tensor, or the list of its R slices
    (returned as a new list, nothing copied).  Returns ``(x, states)``:
    the active rank's runtime state picks up the pipeline's accounting,
    the other ranks' slices and states pass through."""
    return _rank_apply("send", x, active_rank, dp, tag, state, tenant)


def rank_complete(x: torch.Tensor, active_rank: int, dp: Dataplane,
                  tag: str = "verbs/completion", state=None,
                  tenant: str | None = None):
    """Apply ``dp.pipeline``'s completion-side stages (interrupt wait,
    bounce copy) to slice ``active_rank`` only; the convention of
    :func:`rank_mediate`."""
    return _rank_apply("complete", x, active_rank, dp, tag, state, tenant)


class _Tally:
    """The verbs layer's own counter bumps of one call, per (rank,
    tenant): sums on the host, a high-water mark for ``cq_depth``.
    :meth:`fold` adds them to the runtime states once; no pipeline stage
    writes these columns, so the order of the adds does not matter."""

    def __init__(self):
        self.adds: dict[tuple[int, int], dict[str, float]] = {}
        self.peaks: dict[tuple[int, int], float] = {}

    def bump(self, rank: int, ti: int, **kw) -> None:
        row = self.adds.setdefault((rank, int(ti)), {})
        for k, v in kw.items():
            if v:
                row[k] = row.get(k, 0.0) + float(v)

    def value(self, rank: int, ti: int, name: str) -> float:
        return self.adds.get((rank, int(ti)), {}).get(name, 0.0)

    def peak(self, rank: int, ti: int, depth: int) -> None:
        key = (rank, int(ti))
        self.peaks[key] = max(self.peaks.get(key, 0.0), float(depth))

    def fold(self, states):
        if states is None:
            return None
        states = list(states)
        for (r, ti), row in self.adds.items():
            if row and "counters" in states[r]:
                states[r] = {**states[r], "counters": tl.tenant_counters_bump(
                    states[r]["counters"], ti, **row)}
        for (r, ti), depth in self.peaks.items():
            if "counters" in states[r]:
                states[r] = {**states[r], "counters": tl.tenant_counters_peak(
                    states[r]["counters"], ti, cq_depth=depth)}
        return states


def allreduce_state(state):
    """Aggregate per-rank runtime states into one report covering both
    endpoints: every leaf summed over the ranks, in rank order, and the
    ``cq_depth`` high-water column the max across ranks — ``repro``'s
    psum / pmax, QoS tokens included (an aggregated state is a report,
    not a resumable state)."""
    if state is None:
        return None
    if isinstance(state, dict):
        return state
    states = list(state)

    def fold(vals):
        if isinstance(vals[0], dict):
            return {k: fold([v[k] for v in vals]) for k in vals[0]}
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return total

    out = {}
    for k in states[0]:
        summed = fold([s[k] for s in states])
        if k == "counters":
            peak = states[0][k][..., tl.CTR_CQ_DEPTH]
            for s in states[1:]:
                peak = torch.maximum(peak, s[k][..., tl.CTR_CQ_DEPTH])
            summed = summed.clone()
            summed[..., tl.CTR_CQ_DEPTH] = peak
        out[k] = summed
    return out


# ---------------------------------------------------------------------------
# CQ ring primitives (connection state, on the host)
# ---------------------------------------------------------------------------

def _cqe_push(q: dict, D: int, want: bool, status: int, wrid: int) -> None:
    """Push one CQE when ``want``; track the occupancy high-water mark.  A
    full ring sheds the CQE into the QP's cumulative ``cq_shed``."""
    do = bool(want) and q["cq_head"] - q["cq_tail"] < D
    if do:
        slot = q["cq_head"] % D
        q["cq_status"][slot] = status
        q["cq_wrid"][slot] = wrid
        q["cq_head"] += 1
    q["cq_hwm"] = max(q["cq_hwm"], q["cq_head"] - q["cq_tail"])
    q["cq_shed"] += int(bool(want) and not do)


def _cqe_push_n(q: dict, D: int, n: int, status: int, wrid0: int) -> None:
    """Push ``n`` CQEs with consecutive wr_ids from ``wrid0``, clamped to
    the ring's free space; the excess is shed into ``cq_shed``."""
    free = max(D - (q["cq_head"] - q["cq_tail"]), 0)
    want = max(int(n), 0)
    n = min(want, free)
    for k in range(n):
        idx = (q["cq_head"] + k) % D
        q["cq_status"][idx] = status
        q["cq_wrid"][idx] = wrid0 + k
    q["cq_head"] += n
    q["cq_hwm"] = max(q["cq_hwm"], q["cq_head"] - q["cq_tail"])
    q["cq_shed"] += want - n


def _cqe_consume(q: dict, D: int, n: int) -> None:
    """Consume ``n`` CQEs from the tail (slots return to CQE_EMPTY)."""
    avail = q["cq_head"] - q["cq_tail"]
    n = min(max(int(n), 0), min(avail, D))
    for k in range(n):
        q["cq_status"][(q["cq_tail"] + k) % D] = CQE_EMPTY
    q["cq_tail"] += n


def cq_occupancy(qp: dict) -> int:
    """Outstanding (unconsumed) CQEs."""
    return int(qp["cq_head"]) - int(qp["cq_tail"])


# ---------------------------------------------------------------------------
# data-plane verbs
# ---------------------------------------------------------------------------

def _token(device) -> torch.Tensor:
    """The scalar a completion-side pipeline or a stall chain runs on
    (``repro``'s ``jnp.float32(1.0)``)."""
    return torch.ones((), dtype=torch.float32, device=device)


def post_send(dp: Dataplane, cfg: QPConfig, qp: dict, buf: torch.Tensor,
              src: int, state=None, tenant: str | None = None):
    """Enqueue the rank-stacked ``buf`` (R, slot) into the send ring, each
    rank its own slice, mediated on rank ``src`` (the syscall).  Returns
    ``(qp, states)``."""
    buf, states = rank_mediate(buf, src, dp, tag="verbs/post_send",
                               state=state, tenant=tenant)
    ring = qp["send_ring"].clone()
    ring[:, qp["sq_head"] % cfg.depth] = buf
    return {**qp, "send_ring": ring, "sq_head": qp["sq_head"] + 1}, states


def post_recv(dp: Dataplane, cfg: QPConfig, qp: dict, dst: int, n: int = 1,
              state=None, tenant: str | None = None):
    """Post ``n`` receive buffers on rank ``dst``: the receiver's syscall
    and the credit grant of the flow-control protocol.  Returns ``(qp,
    states)``."""
    states = _rank_states(state, qp["recv_ring"].shape[0])
    tok = torch.zeros((), dtype=torch.float32, device=qp["recv_ring"].device)
    _side(dp, "send", tok, dst, "verbs/post_recv", states, tenant)
    return {**qp, "credits": qp["credits"] + int(n)}, states


def flush_send(dp: Dataplane, cfg: QPConfig, qp: dict, src: int, dst: int,
               *, op: str = "send", state=None, tenant: str | None = None):
    """The NIC DMA: move the send ring src→dst (or dst→src for READ) as one
    mediated ``dp.ppermute`` whose pipeline runs on every rank with its
    own state.

    ``op``: "send" (two-sided), "write" / "read" (one-sided; RC only).
    Send / write completions land in the CQ ring; a READ completes no
    posted send.  CQEs shed on a full CQ ring land in the issuing
    tenant's ``cq_shed`` counter.  Returns ``(qp, states)``."""
    if op != "send" and cfg.transport != "RC":
        raise TransportError(f"one-sided {op!r} requires RC transport")
    perm = [(src, dst)] if op != "read" else [(dst, src)]
    ring = qp["send_ring"] if op != "read" else qp["recv_ring"]
    states = _rank_states(state, ring.shape[0])
    r, states = dp.ppermute(ring, cfg.axis, perm, tag=f"verbs/{op}",
                            mr=None, state=states)
    new = _work(qp)
    if op == "read":
        new["send_ring"] = r      # reader pulled remote memory
        return new, states
    new["recv_ring"] = r
    # the DMA completes every posted send: push their CQEs
    _cqe_push_n(new, cfg.effective_cq_depth, qp["sq_head"] - qp["cq_sent"],
                CQE_SEND, qp["cq_sent"])
    new["cq_sent"] = qp["sq_head"]
    tally = _Tally()
    tally.bump(src, dp.tenant_index(tenant),
               cq_shed=new["cq_shed"] - qp["cq_shed"])
    return new, tally.fold(states)


def poll_cq(dp: Dataplane, cfg: QPConfig, qp: dict, poller: int, state=None,
            tenant: str | None = None):
    """Drain the completion queue on rank ``poller``.

    Returns ``(completions, qp, states)`` where ``completions`` is the
    number of deliveries since the last poll (``cq_sent - cq_rcvd``).
    Consumes every outstanding CQE and bumps the poller's
    ``completions`` counter; error-status CQEs also land in
    ``cqe_errors``.  Pays the interrupt cost on the polling rank when
    polling is disabled."""
    ring, states = rank_complete(qp["recv_ring"], poller, dp,
                                 tag="verbs/poll_cq", state=state,
                                 tenant=tenant)
    D = cfg.effective_cq_depth
    completed = qp["cq_sent"] - qp["cq_rcvd"]
    live = min(cq_occupancy(qp), D)
    st = qp["cq_status"][(qp["cq_tail"] + np.arange(live)) % D]
    nerr = int(np.sum((st == CQE_ERR_RETRY) | (st == CQE_ERR_FATAL)))
    tally = _Tally()
    tally.bump(poller, dp.tenant_index(tenant), completions=completed,
               cqe_errors=nerr)
    new = _work(qp)
    _cqe_consume(new, D, cq_occupancy(qp))
    new.update(recv_ring=ring, cq_rcvd=qp["cq_sent"])
    return completed, new, tally.fold(states)


# ---------------------------------------------------------------------------
# the CQ-driven async runtime: sender window + credit flow control
# ---------------------------------------------------------------------------

def _check_windowed(cfg: QPConfig, op: str) -> None:
    if op not in ("send", "write", "read"):
        raise TransportError(f"unknown windowed op {op!r}")
    if op != "send" and cfg.transport != "RC":
        raise TransportError(f"one-sided {op!r} requires RC transport")


def _transmit(dp, dp_peer, q, msgs, out, idx, src, dst, op, tag, states,
              tenant, deliver: bool) -> None:
    """One posted WR of message ``idx``: every rank writes its own payload
    into its send-ring slot, rank ``src``'s through the pipeline's send
    side (the syscall); the DMA reads the registered slot (zero copy), or
    for READ the remote memory; when ``deliver``, the payload lands in the
    receiving rank's recv-ring slot and ``out``, through its completion
    side for a two-sided op, and every other rank's recv slot reads 0."""
    slot = q["sq_head"] % q["send_ring"].shape[1]
    payload = msgs[:, idx]
    ps = payload[src]
    wire = _side(dp, "send", ps, src, tag, states, tenant)
    ring = q["send_ring"]
    ring[:, slot] = payload
    if wire is not ps:
        ring[src, slot] = wire
    if not deliver:
        return
    a, b = (dst, src) if op == "read" else (src, dst)
    rx = payload[a] if op == "read" else ring[a, slot]
    if op == "send":
        rx = _side(dp_peer, "complete", rx, b, "verbs/rx_complete", states,
                   tenant)
    rr = q["recv_ring"]
    rr[:, slot] = 0
    rr[b, slot] = rx
    out[b, idx] = rx


def windowed_send(dp: Dataplane, cfg: QPConfig, qp: dict,
                  msgs: torch.Tensor, src: int, dst: int, *,
                  op: str = "send", state=None, tenant: str | None = None,
                  dp_peer: Dataplane | None = None, fault=None):
    """Transmit the rank-stacked ``msgs`` (R, n, slot) src→dst through the
    async CQ runtime, one WR event per tick:

    * **post** when the window (``cfg.max_outstanding``) has room and (two
      sided only) a receiver credit is left: the payload goes into the
      send ring (send-side pipeline on ``src``), is DMA'd, lands on the
      receiving rank and its CQE is pushed;
    * **drain** when the window is full or input is exhausted: the sender
      consumes the oldest CQE (completion-side pipeline on ``src``);
    * **stall** when a two-sided send has no credits: the sender pays the
      interrupt-wait chain, then the receiver re-posts its consumed
      buffers.

    Returns ``(out, qp, states)``: ``out`` (R, n, slot) holds the
    delivered payloads on the receiving rank (``dst``, or ``src`` for
    READ) and zeros elsewhere; ``states`` is the list of per-rank runtime
    states.  For ``op="read"`` ``msgs[dst]`` is the remote memory.

    ``fault`` (a :class:`~repro_torch.runtime.fault.WireFault`) arms the
    go-back-N retransmission machine: a corrupted WR completes with
    ``CQE_ERR_RETRY``, a dropped one times out after ``cfg.rto_ticks``
    idle ticks, and either rewinds the window to the last in-order ack,
    backs off and re-posts through the full mediation path, so the
    delivery is bit-identical to a lossless run; after
    ``cfg.retry_limit`` consecutive failed retries the QP turns fatal
    and undelivered slots stay zero."""
    _check_windowed(cfg, op)
    R, n = int(msgs.shape[0]), int(msgs.shape[1])
    states = _rank_states(state, R)
    if n == 0:
        return torch.zeros_like(msgs), qp, states
    if fault is not None and fault.active:
        return _windowed_send_rtx(dp, cfg, qp, msgs, src, dst, op=op,
                                  states=states, tenant=tenant,
                                  dp_peer=dp_peer, fault=fault)
    W = min(cfg.max_outstanding, cfg.effective_cq_depth)
    D = cfg.effective_cq_depth
    uses_credits = op == "send"
    dp_peer = dp_peer if dp_peer is not None else dp
    ti = dp.tenant_index(tenant)
    stall_iters = (tech.iters_for_ns(dp.cfg.interrupt_cost_us * 1e3,
                                     device=dp.device)
                   if dp.cfg.emulate_costs else 0)
    # fuel: every message needs at most post + drain + stall ticks, plus
    # the tail drain of a full window: a hard bound on the loop's length
    fuel = 3 * n + 2 * W + 8
    tag = f"verbs/windowed_{op}"
    q = _work(qp, clone_rings=True)
    out = torch.zeros_like(msgs)
    tok = _token(msgs.device)
    tally = _Tally()
    cs0 = q["cq_sent"]
    t = i = 0
    while t < fuel and not (i >= n and q["cq_sent"] - cs0 >= n):
        in_flight = q["sq_head"] - q["cq_sent"]
        have_credit = q["credits"] > 0 if uses_credits else True
        can_post = i < n and in_flight < W and have_credit
        cq_ready = q["cq_head"] - q["cq_tail"] > 0
        do_drain = not can_post and cq_ready and (in_flight >= W or i >= n)
        do_stall = not can_post and not do_drain and i < n and in_flight < W

        # -- post, DMA and delivery ---------------------------------------
        if can_post:
            _transmit(dp, dp_peer, q, msgs, out, i, src, dst, op, tag,
                      states, tenant, deliver=True)
        _cqe_push(q, D, can_post, CQE_SEND, q["sq_head"])
        q["sq_head"] += int(can_post)
        if uses_credits:
            q["credits"] -= int(can_post)
            q["rx_owed"] += int(can_post)
        q["win_hwm"] = max(q["win_hwm"], q["sq_head"] - q["cq_sent"])

        # -- drain: lazy CQ poll on the sender ----------------------------
        if do_drain:
            _side(dp, "complete", tok, src, "verbs/cq_drain", states, tenant)
        _cqe_consume(q, D, int(do_drain))
        q["cq_sent"] += int(do_drain)

        # -- stall: credit exhaustion -------------------------------------
        if uses_credits:
            if stall_iters and do_stall:
                tech.delay_chain(tok, stall_iters)
            # the stalled sender's wakeup: the receiver polled its recvs
            # and re-posted every consumed buffer
            if do_stall:
                q["credits"] += q["rx_owed"]
                q["rx_owed"] = 0

        # -- runtime accounting (active side only) ------------------------
        tally.bump(src, ti, credits=int(can_post and uses_credits),
                   completions=int(do_drain), stalls=int(do_stall))
        tally.peak(src, ti, q["cq_head"] - q["cq_tail"])
        t += 1
        i += int(can_post)
    return out, q, tally.fold(states)


def adaptive_rto(srtt, nsamp, cfg: QPConfig) -> np.ndarray:
    """Retransmission timeout from the observed drain latency: ``2 *
    ceil(srtt) + 1`` ticks, clamped to ``[2, cfg.rto_ticks]``; with no
    samples yet the static ``cfg.rto_ticks``.  ``srtt`` is a float32 EWMA
    (gain 1/8) of in-order ack spacing in loop ticks and ``nsamp`` counts
    samples.  Elementwise, so per-QP ``(Q,)`` estimates work too; returns
    int32 numpy."""
    est = 2 * np.ceil(np.asarray(srtt, np.float32)).astype(np.int32) + 1
    return np.where(np.asarray(nsamp) > 0, np.clip(est, 2, cfg.rto_ticks),
                    np.int32(cfg.rto_ticks)).astype(np.int32)


_EWMA_OLD = np.float32(0.875)
_EWMA_NEW = np.float32(0.125)


def _ewma(srtt, sample):
    return _EWMA_OLD * srtt + _EWMA_NEW * sample


def _windowed_send_rtx(dp, cfg, qp, msgs, src, dst, *, op, states, tenant,
                       dp_peer, fault):
    """The lossy-wire variant of :func:`windowed_send`: the same
    post / drain / stall loop with the go-back-N machine armed.

    Per-WR faults roll from ``(wr, attempt)``, so a retry rolls afresh.  A
    corrupted transmission is NAK'd (``CQE_ERR_RETRY``, no delivery); a
    dropped one is silent and the RTO countdown catches it.  Either
    rewinds the window to the last in-order ack, backs off and re-posts.
    Deliveries land by message index, so a duplicate arrival is
    idempotent."""
    n = int(msgs.shape[1])
    W = min(cfg.max_outstanding, cfg.effective_cq_depth)
    D = cfg.effective_cq_depth
    uses_credits = op == "send"
    dp_peer = dp_peer if dp_peer is not None else dp
    ti = dp.tenant_index(tenant)
    stall_iters = (tech.iters_for_ns(dp.cfg.interrupt_cost_us * 1e3,
                                     device=dp.device)
                   if dp.cfg.emulate_costs else 0)
    # fuel: the lossless bound per full pass, times the retry budget, plus
    # RTO countdowns and backoff between passes
    fuel = (cfg.retry_limit + 2) * (3 * n + 2 * W
                                    + cfg.rto_ticks + cfg.backoff_ticks + 8)
    tag = f"verbs/windowed_{op}"
    q = _work(qp, clone_rings=True)
    out = torch.zeros_like(msgs)
    tok = _token(msgs.device)
    tally = _Tally()
    cs0 = q["cq_sent"]
    attempts = [0] * n        # transmissions per message: salts the hash
    t, i = 0, q["sq_head"] - cs0      # resume mid-window after a restore
    rto, fatal = cfg.rto_ticks, False
    srtt, nsamp, last_ack = np.float32(0.0), 0, 0
    while t < fuel and not ((i >= n and q["cq_sent"] - cs0 >= n) or fatal):
        in_flight = q["sq_head"] - q["cq_sent"]
        have_credit = q["credits"] > 0 if uses_credits else True
        backing_off = q["backoff"] > 0
        can_post = (i < n and in_flight < W and have_credit
                    and not backing_off)
        cq_ready = q["cq_head"] - q["cq_tail"] > 0
        do_drain = not can_post and cq_ready
        # silent loss: nothing to post, no CQE arriving, WRs in flight —
        # the retransmission timer runs down to an RTO expiry
        timeout = (not can_post and not cq_ready and not backing_off
                   and in_flight > 0 and rto <= 0)
        do_stall = (not can_post and not do_drain and not backing_off
                    and not timeout and i < n and in_flight < W)

        # -- post (possibly a retransmission), DMA through the fault ------
        idx = min(i, n - 1)
        att = attempts[idx]
        lost = can_post and bool(fault.drops_wr(idx, att))
        bad = can_post and not lost and bool(fault.corrupts_wr(idx, att))
        deliver = can_post and not lost and not bad
        if can_post:
            _transmit(dp, dp_peer, q, msgs, out, idx, src, dst, op, tag,
                      states, tenant, deliver=deliver)
        # invariant: sq_head == cs0 + i, so the CQE wr_id is absolute
        _cqe_push(q, D, deliver, CQE_SEND, q["sq_head"])
        _cqe_push(q, D, bad, CQE_ERR_RETRY, q["sq_head"])
        q["sq_head"] += int(can_post)
        if uses_credits:
            q["credits"] -= int(can_post)
            q["rx_owed"] += int(can_post)
        q["win_hwm"] = max(q["win_hwm"], q["sq_head"] - q["cq_sent"])

        # -- drain one CQE, routed by status + wr_id ----------------------
        tslot = q["cq_tail"] % D
        cqe_st, cqe_wr = int(q["cq_status"][tslot]), int(q["cq_wrid"][tslot])
        is_err = do_drain and cqe_st == CQE_ERR_RETRY
        in_order = do_drain and cqe_st == CQE_SEND and cqe_wr == q["cq_sent"]
        is_gap = do_drain and cqe_st == CQE_SEND and cqe_wr != q["cq_sent"]
        if do_drain:
            _side(dp, "complete", tok, src, "verbs/cq_drain", states, tenant)
        _cqe_consume(q, D, int(do_drain))
        q["cq_sent"] += int(in_order)

        # -- adaptive RTO: sample in-order ack spacing (drain latency) -----
        if in_order:
            sample = np.float32(t - last_ack)
            srtt = sample if nsamp == 0 else _ewma(srtt, sample)
            nsamp += 1
            last_ack = t

        # -- go-back-N rewind: NAK, sequence gap, or RTO expiry -----------
        rew = is_err or is_gap or timeout
        new_retry = q["retry_cnt"] + int(rew)
        give_up = rew and new_retry > cfg.retry_limit
        do_rew = rew and not give_up
        acked_i = q["cq_sent"] - cs0
        if do_rew:
            for m in range(max(acked_i, 0), min(i, n)):
                attempts[m] += 1
            _cqe_consume(q, D, q["cq_head"] - q["cq_tail"])
            q["sq_head"] = q["cq_sent"]
            q["backoff"] = cfg.backoff_ticks
        else:
            q["backoff"] = max(q["backoff"] - int(backing_off), 0)
        q["retry_cnt"] = new_retry if rew else \
            (0 if in_order else q["retry_cnt"])
        i = acked_i if do_rew else i + int(can_post)
        fatal = fatal or give_up
        _cqe_push(q, D, give_up, CQE_ERR_FATAL, q["cq_sent"])

        # -- stall / backoff: both pay the interrupt-wait cost ------------
        if stall_iters and (do_stall or backing_off):
            tech.delay_chain(tok, stall_iters)
        if uses_credits and do_stall:
            q["credits"] += q["rx_owed"]
            q["rx_owed"] = 0

        # any forward progress (or a rewind) re-arms the RTO
        armed = int(adaptive_rto(srtt, nsamp, cfg)) if cfg.adaptive_rto \
            else cfg.rto_ticks
        rto = armed if (can_post or do_drain or rew or backing_off) \
            else rto - 1

        # -- runtime accounting (active side only) ------------------------
        if can_post:
            tally.bump(src, ti, credits=int(uses_credits),
                       retransmits=int(att > 0))
        tally.bump(src, ti, completions=int(do_drain),
                   cqe_errors=int(is_err), stalls=int(do_stall),
                   timeouts=int(timeout))
        tally.peak(src, ti, q["cq_head"] - q["cq_tail"])
        t += 1
    return out, q, tally.fold(states)


# ---------------------------------------------------------------------------
# live QP migration (MigrOS-style): quiesce → stop-and-copy → restore.
# Because every WR crosses the mediation layer, the kernel can stop a
# connection at a clean point, copy its state, and resume it elsewhere.
# ---------------------------------------------------------------------------

# Payload rings diverge per rank; every other QP leaf is connection state.
_QP_RING_KEYS = ("send_ring", "recv_ring")
_QP_UNIFORM_KEYS = ("sq_head", "cq_sent", "cq_rcvd", "cq_status", "cq_wrid",
                    "cq_head", "cq_tail", "cq_hwm", "credits", "rx_owed",
                    "win_hwm", "retry_cnt", "backoff", "rtx_pending",
                    "cq_shed")


def qp_specs(axis: str = "rank") -> dict:
    """``repro``'s partition of a QP: payload rings split over ``axis``
    (``(axis, None)``: a snapshot holds them as ``(R·depth, slot)``),
    every other leaf replicated (``()``).  The port's snapshot layout."""
    specs = {k: () for k in _QP_UNIFORM_KEYS}
    specs.update({k: (axis, None) for k in _QP_RING_KEYS})
    return specs


def qp_quiesce(dp: Dataplane, cfg: QPConfig, qp: dict, src: int, state=None,
               tenant: str | None = None):
    """Drain the connection to a migratable snapshot (MigrOS's stop
    phase): consume the CQ one entry per tick, paying the completion-side
    pipeline on ``src`` per CQE, routing each as the retransmission
    machine does: an in-order ``CQE_SEND`` acks, an error CQE or a
    sequence gap marks its WR in ``rtx_pending``.  Then every in-flight
    WR without a CQE (silently dropped) lands in ``rtx_pending`` and the
    window is rewound.  Credits, ``rx_owed``, ``retry_cnt`` / ``backoff``
    and the cumulative counters are untouched, so a transfer split
    around quiesce → :func:`qp_snapshot` → :func:`qp_restore` completes
    bit-identically.  Returns ``(qp, states)``."""
    states = _rank_states(state, qp["send_ring"].shape[0])
    ti = dp.tenant_index(tenant)
    D = cfg.effective_cq_depth
    q = _work(qp)
    tok = _token(qp["send_ring"].device)
    tally = _Tally()
    while q["cq_head"] - q["cq_tail"] > 0:
        _side(dp, "complete", tok, src, "verbs/quiesce", states, tenant)
        tslot = q["cq_tail"] % D
        st, wr = int(q["cq_status"][tslot]), int(q["cq_wrid"][tslot])
        is_err = st in (CQE_ERR_RETRY, CQE_ERR_FATAL)
        in_order = st == CQE_SEND and wr == q["cq_sent"]
        is_gap = st == CQE_SEND and wr > q["cq_sent"]
        # wr < cq_sent (an already-acked flush CQE) just drains
        tally.bump(src, ti, completions=1, cqe_errors=int(is_err))
        _cqe_consume(q, D, 1)
        q["cq_sent"] += int(in_order)
        q["rtx_pending"] += int(is_err or is_gap)
    q["rtx_pending"] += q["sq_head"] - q["cq_sent"]   # in flight, no CQE
    q["sq_head"] = q["cq_sent"]
    q["cq_rcvd"] = q["cq_sent"]
    return q, tally.fold(states)


def _host_copy(v, ring_key: bool) -> np.ndarray:
    if ring_key:
        a = v.detach().cpu().numpy()
        return a.reshape((-1,) + a.shape[2:])      # ranks folded into rows
    return np.array(v, dtype=np.int32)


def qp_snapshot(qp: dict) -> dict:
    """Stop-and-copy a (quiesced) QP into host memory as numpy in
    ``repro``'s layout: the rings ``(R·depth, slot)`` (rank ``r``'s ring is
    rows ``r·depth`` on), int32 connection state, the same keys.  A
    snapshot from either package restores into either."""
    return {k: _host_copy(v, k in _QP_RING_KEYS) for k, v in qp.items()}


def _restore(host: dict, specs: dict, ring_keys, mesh, axis, device,
             what: str) -> dict:
    missing = set(specs) - set(host)
    if missing:
        raise TransportError(f"{what} snapshot missing keys "
                             f"{sorted(missing)} — not a {what} pytree")
    ranks = mesh.axis_size(axis) if mesh is not None else 2
    dev = resolve_device(device)
    out = {}
    for k, v in host.items():
        v = np.asarray(v)
        if k in ring_keys:
            if v.shape[0] % ranks:
                raise TransportError(f"{k} has {v.shape[0]} rows, not a "
                                     f"multiple of {ranks} ranks")
            out[k] = torch.from_numpy(v.copy()).reshape(
                (ranks, v.shape[0] // ranks) + v.shape[1:]).to(dev)
        elif v.ndim == 0:
            out[k] = int(v)
        else:
            out[k] = v.astype(np.int32, copy=True)
    return out


def qp_restore(qp_host: dict, mesh=None, *, axis: str = "rank",
               device=None) -> dict:
    """MigrOS restore: a QP snapshot (``repro``'s layout, from either
    package) back into a QP on ``device``, its rings split over ``mesh``'s
    ``axis`` (2 ranks without a mesh), so a windowed transfer resumes
    where it stopped, cursors, credits and owed re-posts intact."""
    return _restore(qp_host, qp_specs(axis), _QP_RING_KEYS, mesh, axis,
                    device, "QP")


# ---------------------------------------------------------------------------
# the connection table: many QPs on one shared CQ + SRQ.  Every QP's CQEs
# go to one completion queue (each tagged with its qp_id + epoch, one
# drain loop for the table) and one shared receive queue grants buffers
# to whichever QP delivers next; post order across tenants' QPs is
# arbitrated by the QoS token buckets the mediation layer already owns.
# ---------------------------------------------------------------------------

_CONN_RING_KEYS = ("send_ring", "recv_ring")
_CONN_QP_KEYS = ("sq_head", "cq_sent", "cq_rcvd", "win_hwm", "retry_cnt",
                 "backoff", "rtx_pending", "epoch", "srq_grants",
                 "retransmits", "timeouts")
_CONN_CQ_KEYS = ("cq_status", "cq_wrid", "cq_qp", "cq_epoch")
_CONN_SCALAR_KEYS = ("cq_head", "cq_tail", "cq_hwm", "cq_shed",
                     "srq_credits", "srq_owed")


def conn_init(cfg: QPConfig, num_qps: int, dtype=None, *, ranks: int = 2,
              device=None) -> dict:
    """Create a connection table: ``num_qps`` QPs sharing one CQ and one
    SRQ.  Per-QP state is ``(Q,)`` int32 (rings ``(R, Q, depth, slot)`` on
    ``device``); the shared CQ's entries carry ``(status, wr_id, qp_id,
    epoch)``: the qp_id routes a completion back to its QP, the epoch lets
    a rewound QP's stale CQEs be discarded at drain time.  ``cq_depth ==
    0`` sizes the shared ring to hold every QP's full window."""
    if num_qps < 1:
        raise TransportError(f"need num_qps >= 1, got {num_qps}")
    dt, slot = _slot_elems(cfg, dtype)
    dev = resolve_device(device)
    Q = int(num_qps)
    D = cfg.cq_depth or max(cfg.depth, cfg.max_outstanding) * Q
    conn = {
        "send_ring": torch.zeros((ranks, Q, cfg.depth, slot), dtype=dt,
                                 device=dev),
        "recv_ring": torch.zeros((ranks, Q, cfg.depth, slot), dtype=dt,
                                 device=dev),
    }
    conn.update({k: np.zeros((Q,), np.int32) for k in _CONN_QP_KEYS})
    conn.update({
        "cq_status": np.zeros((D,), np.int32),
        "cq_wrid": np.full((D,), -1, np.int32),
        "cq_qp": np.full((D,), -1, np.int32),
        "cq_epoch": np.zeros((D,), np.int32),
    })
    conn.update({k: 0 for k in _CONN_SCALAR_KEYS})
    return conn


def conn_specs(num_qps: int | None = None, axis: str = "rank") -> dict:
    """The :func:`qp_specs` analogue for a connection table: rings split
    over ``axis`` (``(axis, None, None)``: ``(R·Q, depth, slot)`` in a
    snapshot), everything else replicated.  ``num_qps`` is accepted for
    symmetry but unused."""
    specs = {k: () for k in
             _CONN_QP_KEYS + _CONN_CQ_KEYS + _CONN_SCALAR_KEYS}
    specs.update({k: (axis, None, None) for k in _CONN_RING_KEYS})
    return specs


def _conn_cqe_push(c: dict, want: bool, status: int, wrid: int, qp_id: int,
                   epoch: int) -> None:
    """Push one tagged CQE onto the shared CQ when ``want``; sheds on
    overrun into the table's cumulative ``cq_shed``."""
    D = c["cq_status"].shape[0]
    do = bool(want) and c["cq_head"] - c["cq_tail"] < D
    if do:
        slot = c["cq_head"] % D
        c["cq_status"][slot] = status
        c["cq_wrid"][slot] = wrid
        c["cq_qp"][slot] = qp_id
        c["cq_epoch"][slot] = epoch
        c["cq_head"] += 1
    c["cq_hwm"] = max(c["cq_hwm"], c["cq_head"] - c["cq_tail"])
    c["cq_shed"] += int(bool(want) and not do)


def _conn_cqe_pop(c: dict, want: bool) -> None:
    """Consume the tail CQE of the shared CQ when ``want``."""
    if want and c["cq_head"] - c["cq_tail"] > 0:
        c["cq_status"][c["cq_tail"] % c["cq_status"].shape[0]] = CQE_EMPTY
        c["cq_tail"] += 1


def srq_post(dp: Dataplane, cfg: QPConfig, conn: dict, dst: int, n: int = 1,
             state=None, tenant: str | None = None):
    """Post ``n`` receive buffers to the shared receive queue on rank
    ``dst``: one mediated syscall grants credits any QP of the table may
    consume.  Returns ``(conn, states)``."""
    states = _rank_states(state, conn["recv_ring"].shape[0])
    tok = torch.zeros((), dtype=torch.float32,
                      device=conn["recv_ring"].device)
    _side(dp, "send", tok, dst, "verbs/srq_post", states, tenant)
    return {**conn, "srq_credits": conn["srq_credits"] + int(n)}, states


def _pay(x: torch.Tensor, iters: int, copies: int) -> torch.Tensor:
    """A side's mediation cost paid by hand: the delay chain (the dataplane
    kernel's ``mediated_cost`` on the card) and the bounce copies
    (``bounce_copy``)."""
    if iters:
        x = tech.delay_chain(x, iters)
    if copies:
        x = tech.staged_copy(x, copies=copies)
    return x


def conn_send(dp: Dataplane, cfg: QPConfig, conn: dict, msgs: torch.Tensor,
              src: int, dst: int, *, state=None,
              tenants: tuple[str, ...] | None = None, fault=None):
    """Transmit the rank-stacked ``msgs`` (R, Q, n, slot) src→dst: every QP
    of the table sends its n messages, multiplexed through the shared CQ
    and SRQ by one event loop, one event per tick:

    * **post**: the QoS token buckets arbitrate which eligible QP posts
      (:meth:`~repro_torch.core.policies.QoSPolicy.arb_scores`, scored
      from ``src``'s state: the most tokens after refill wins, ties rotate
      round-robin).  The winner pays the send-side cost, is charged a
      token, consumes one SRQ credit and its delivery is granted an SRQ
      buffer; its CQE lands tagged with the QP's id and epoch;
    * **drain**: when no QP can post, the oldest shared CQE routes back to
      its QP: an in-order ``CQE_SEND`` acks, a NAK or sequence gap rewinds
      that QP only (its epoch increments, so its stale CQEs are discarded
      at drain);
    * **stall**: SRQ dry: the receiver re-posts consumed buffers, the
      sender pays the interrupt-wait cost;
    * **RTO**: per-QP timers run down on idle ticks and rewind silently
      dropped windows.

    ``tenants`` maps each QP to a tenant (default: the dataplane's);
    ``fault`` injects faults with WR identity ``qp * n + msg``.  A QP
    whose retries run out turns fatal and its undelivered slots stay
    zero.  Returns ``(out, conn, states)``."""
    if cfg.transport != "RC":
        raise TransportError("conn_send requires RC transport")
    R, Q, n = (int(s) for s in msgs.shape[:3])
    if Q != conn["sq_head"].shape[0]:
        raise TransportError(
            f"msgs has {Q} QPs but the table holds "
            f"{conn['sq_head'].shape[0]}")
    states = _rank_states(state, R)
    if n == 0:
        return torch.zeros_like(msgs), conn, states
    tenants = tuple(tenants) if tenants is not None \
        else (dp.tenant,) * Q
    if len(tenants) != Q:
        raise TransportError(
            f"tenants has {len(tenants)} entries for {Q} QPs")
    W = min(cfg.max_outstanding, cfg.depth)
    ti_arr = np.array([dp.tenant_index(t) for t in tenants], np.int32)
    stall_iters = (tech.iters_for_ns(dp.cfg.interrupt_cost_us * 1e3,
                                     device=dp.device)
                   if dp.cfg.emulate_costs else 0)
    # per-op mediation cost, paid by hand (the pipeline's stateful stages
    # key on a tenant fixed before the op; the arbitration winner is not)
    # with the same stage-reported totals
    rec = _verbs_rec(dp, msgs[0, 0, 0], "verbs/conn_send")
    send_iters = dp.pipeline.send_delay_iters(rec)
    send_copies = dp.pipeline.send_copies(rec)
    comp_iters = dp.pipeline.complete_delay_iters(rec)
    comp_copies = dp.pipeline.complete_copies(rec)
    qos = next((p for p in dp.policies
                if isinstance(p, QoSPolicy) and p.rates), None) \
        if dp.enforce else None
    rates = qos.rates_for(tenants) if qos is not None else None
    score_args = None
    if qos is not None and states is not None and qos.name in states[src]:
        dev = states[src][qos.name]["tokens"].device
        score_args = (torch.tensor(ti_arr, dtype=torch.long, device=dev),
                      torch.tensor(rates, dtype=torch.float32, device=dev))
    quota = next((p for p in dp.policies if isinstance(p, QuotaPolicy)),
                 None) if (dp.enforce and not dp.kernel_bypass) else None
    lims = [float(quota.limits.get(t, np.inf)) for t in tenants] \
        if quota is not None else None
    mediated = not dp.kernel_bypass

    fuel = ((cfg.retry_limit + 2) * Q
            * (3 * n + 2 * W + cfg.rto_ticks + cfg.backoff_ticks + 8))
    c = _work(conn, clone_rings=True)
    send_ring, recv_ring = c["send_ring"], c["recv_ring"]
    D = c["cq_status"].shape[0]
    depth = send_ring.shape[2]
    out = torch.zeros_like(msgs)
    tok = _token(msgs.device)
    tally = _Tally()
    cs0 = c["cq_sent"].copy()
    attempts = np.zeros((Q, n), np.int32)
    arq = np.arange(Q, dtype=np.int32)
    arn = np.arange(n, dtype=np.int32)
    i_arr = (c["sq_head"] - cs0).astype(np.int32)
    rto_arr = np.full((Q,), cfg.rto_ticks, np.int32)
    rr = 0
    srtt_q = np.zeros((Q,), np.float32)
    nsamp_q = np.zeros((Q,), np.int32)
    last_ack_q = np.zeros((Q,), np.int32)
    t = 0
    while t < fuel and not np.all((c["cq_sent"] - cs0 >= n)
                                  | (c["retry_cnt"] > cfg.retry_limit)):
        in_flight = c["sq_head"] - c["cq_sent"]                 # (Q,)
        fatal_q = c["retry_cnt"] > cfg.retry_limit
        backing = c["backoff"] > 0
        elig = (i_arr < n) & (in_flight < W) & ~backing & ~fatal_q
        have_srq = c["srq_credits"] > 0
        any_elig = bool(elig.any())
        can_post = have_srq and any_elig
        cq_ready = c["cq_head"] - c["cq_tail"] > 0
        do_drain = not can_post and cq_ready
        timeout_q = ((not can_post and not cq_ready) & (in_flight > 0)
                     & ~backing & (rto_arr <= 0))               # (Q,)
        do_stall = (not can_post and not cq_ready and not timeout_q.any()
                    and not have_srq and any_elig)

        # -- arbitration: the token buckets pick the next QP to post (most
        #    tokens after refill wins, ties rotate round-robin) ------------
        if score_args is not None:
            score = qos.arb_scores(states[src], *score_args).cpu().numpy()
        else:
            score = np.ones((Q,), np.float32)
        score = np.where(elig, score, np.float32(-np.inf))
        cand = elig & (score >= score.max() - np.float32(1e-6))
        pick = int(np.argmin(np.where(cand, (arq - rr) % Q, Q)))
        oh_pick = (arq == pick) & can_post
        ti_pick = int(ti_arr[pick])
        idx = min(int(i_arr[pick]), n - 1)
        att = int(attempts[pick, idx])
        slot = int(c["sq_head"][pick]) % depth
        deliver = bad = False

        # -- post: cost, token charge, accounting, fault, delivery ---------
        if can_post:
            payload = msgs[:, pick, idx]
            ps = payload[src]
            wire = _pay(ps, send_iters, send_copies)
            if qos is not None and states is not None:
                for r in range(R):
                    states[r] = qos.charge_wr(states[r], ti_pick, rates[pick],
                                              True, bump_mask=r == src)
            if mediated:
                tally.bump(src, ti_pick, ops=1, bytes=rec.bytes,
                           retransmits=int(att > 0))
            send_ring[:, pick, slot] = payload
            if wire is not ps:
                send_ring[src, pick, slot] = wire
            wr_global = pick * n + idx
            lost = fault is not None and bool(fault.drops_wr(wr_global, att))
            bad = fault is not None and not lost and \
                bool(fault.corrupts_wr(wr_global, att))
            deliver = not lost and not bad
            # -- delivery: an SRQ buffer is granted to whichever QP lands
            if deliver:
                rx = _pay(send_ring[src, pick, slot], comp_iters, comp_copies)
                recv_ring[:, pick, slot] = 0
                recv_ring[dst, pick, slot] = rx
                out[dst, pick, idx] = rx
        sq_pick = int(c["sq_head"][pick])
        ep_pick = int(c["epoch"][pick])
        _conn_cqe_push(c, deliver, CQE_SEND, sq_pick, pick, ep_pick)
        _conn_cqe_push(c, bad, CQE_ERR_RETRY, sq_pick, pick, ep_pick)
        dgrant = int(deliver)
        c["sq_head"] = c["sq_head"] + oh_pick.astype(np.int32)
        c["srq_credits"] -= int(can_post)
        c["srq_owed"] += int(can_post)
        c["srq_grants"] = c["srq_grants"] + oh_pick.astype(np.int32) * dgrant
        c["retransmits"] = c["retransmits"] \
            + oh_pick.astype(np.int32) * int(att > 0)
        c["win_hwm"] = np.maximum(c["win_hwm"], c["sq_head"] - c["cq_sent"])
        i_arr = i_arr + oh_pick.astype(np.int32)
        if can_post:
            tally.bump(src, ti_pick, credits=1, srq_grants=dgrant)

        # -- drain: route the oldest shared CQE back to its QP -------------
        tslot = c["cq_tail"] % D
        cqe_st, cqe_wr = int(c["cq_status"][tslot]), int(c["cq_wrid"][tslot])
        qt = min(max(int(c["cq_qp"][tslot]), 0), Q - 1)
        stale = do_drain and int(c["cq_epoch"][tslot]) != int(c["epoch"][qt])
        live = do_drain and not stale
        is_err = live and cqe_st == CQE_ERR_RETRY
        in_order = live and cqe_st == CQE_SEND \
            and cqe_wr == int(c["cq_sent"][qt])
        is_gap = live and cqe_st == CQE_SEND \
            and cqe_wr > int(c["cq_sent"][qt])
        oh_qt = arq == qt
        if live:
            _pay(tok, comp_iters, comp_copies)
        _conn_cqe_pop(c, do_drain)
        hit = oh_qt & in_order                                   # (Q,)
        c["cq_sent"] = c["cq_sent"] + hit.astype(np.int32)

        # -- adaptive RTO: per-QP EWMA of in-order ack spacing -------------
        sample = (t - last_ack_q).astype(np.float32)
        srtt_q = np.where(hit, np.where(nsamp_q == 0, sample,
                                        _ewma(srtt_q, sample)),
                          srtt_q).astype(np.float32)
        nsamp_q = nsamp_q + hit.astype(np.int32)
        last_ack_q = np.where(hit, t, last_ack_q).astype(np.int32)
        if mediated and live:
            tally.bump(src, ti_arr[qt], completions=1,
                       cqe_errors=int(is_err))

        # -- go-back-N rewind, per QP: NAK, gap, or RTO expiry -------------
        rew_q = (oh_qt & (is_err or is_gap)) | timeout_q         # (Q,)
        new_retry = c["retry_cnt"] + rew_q.astype(np.int32)
        do_rew_q = rew_q & ~(new_retry > cfg.retry_limit)
        acked = c["cq_sent"] - cs0                               # (Q,)
        attempts = attempts + (do_rew_q[:, None]
                               & (arn[None, :] >= acked[:, None])
                               & (arn[None, :] < i_arr[:, None])
                               ).astype(np.int32)
        i_arr = np.where(do_rew_q, acked, i_arr).astype(np.int32)
        c["sq_head"] = np.where(do_rew_q, c["cq_sent"],
                                c["sq_head"]).astype(np.int32)
        # the rewound QP's stale CQEs are epoch-discarded at drain: the
        # shared ring is never flushed under the other QPs
        c["epoch"] = c["epoch"] + do_rew_q.astype(np.int32)
        c["backoff"] = np.where(
            do_rew_q, np.int32(cfg.backoff_ticks),
            np.maximum(c["backoff"] - backing.astype(np.int32), 0)
        ).astype(np.int32)
        c["retry_cnt"] = np.where(
            rew_q, new_retry,
            np.where(oh_qt & in_order, 0, c["retry_cnt"])).astype(np.int32)
        c["timeouts"] = c["timeouts"] + timeout_q.astype(np.int32)
        for qi in np.flatnonzero(timeout_q):
            tally.bump(src, ti_arr[qi], timeouts=1)

        # -- quota marking (runtime plane, the winner's tenant) ------------
        if quota is not None and can_post and states is not None \
                and "counters" in states[src]:
            ctrs = states[src]["counters"].clone()
            used = ctrs[ti_pick, tl.CTR_BYTES] \
                + tally.value(src, ti_pick, "bytes")
            ctrs[ti_pick, tl.CTR_DENIED] += (used > lims[pick]).to(
                torch.float32)
            states[src] = {**states[src], "counters": ctrs}

        # -- stall: SRQ dry — the receiver re-posts, the sender waits ------
        if stall_iters and (do_stall or backing.any()):
            tech.delay_chain(tok, stall_iters)
        if do_stall:
            c["srq_credits"] += c["srq_owed"]
            c["srq_owed"] = 0
            tally.bump(src, ti_arr[int(np.argmax(elig))], stalls=1)
        if can_post:
            tally.peak(src, ti_pick, c["cq_head"] - c["cq_tail"])

        # -- per-QP RTO: served QPs re-arm, idle in-flight QPs count down --
        served = oh_pick | (oh_qt & live) | rew_q | backing
        armed = adaptive_rto(srtt_q, nsamp_q, cfg) if cfg.adaptive_rto \
            else np.full((Q,), cfg.rto_ticks, np.int32)
        rto_arr = np.where(
            served, armed,
            np.where(c["sq_head"] - c["cq_sent"] > 0, rto_arr - 1, armed)
        ).astype(np.int32)
        rr = (pick + 1) % Q if can_post else rr
        t += 1
    return out, c, tally.fold(states)


def conn_quiesce(dp: Dataplane, cfg: QPConfig, conn: dict, src: int,
                 state=None, tenants: tuple[str, ...] | None = None):
    """Quiesce the whole connection table (the :func:`qp_quiesce`
    analogue): drain the shared CQ one CQE per tick, routing each to its
    QP, discarding stale-epoch entries, acking in-order completions and
    marking errors and gaps in the owning QP's ``rtx_pending``; then
    rewind every QP's unacked window into ``rtx_pending``.  Retry
    counters, backoff, epochs and SRQ credits are kept.  Returns
    ``(conn, states)``."""
    states = _rank_states(state, conn["send_ring"].shape[0])
    Q = int(conn["sq_head"].shape[0])
    tenants = tuple(tenants) if tenants is not None \
        else (dp.tenant,) * Q
    ti_arr = [dp.tenant_index(t) for t in tenants]
    c = _work(conn)
    D = c["cq_status"].shape[0]
    tok = _token(conn["send_ring"].device)
    tally = _Tally()
    while c["cq_head"] - c["cq_tail"] > 0:
        _side(dp, "complete", tok, src, "verbs/quiesce", states, None)
        tslot = c["cq_tail"] % D
        st, wr = int(c["cq_status"][tslot]), int(c["cq_wrid"][tslot])
        qt = min(max(int(c["cq_qp"][tslot]), 0), Q - 1)
        live = int(c["cq_epoch"][tslot]) == int(c["epoch"][qt])
        is_err = live and st in (CQE_ERR_RETRY, CQE_ERR_FATAL)
        in_order = live and st == CQE_SEND and wr == int(c["cq_sent"][qt])
        is_gap = live and st == CQE_SEND and wr > int(c["cq_sent"][qt])
        tally.bump(src, ti_arr[qt], completions=1, cqe_errors=int(is_err))
        _conn_cqe_pop(c, True)
        c["cq_sent"][qt] += int(in_order)
        c["rtx_pending"][qt] += int(is_err or is_gap)
    c["rtx_pending"] = c["rtx_pending"] + (c["sq_head"] - c["cq_sent"])
    c["sq_head"] = c["cq_sent"].copy()
    c["cq_rcvd"] = c["cq_sent"].copy()
    return c, tally.fold(states)


def conn_snapshot(conn: dict) -> dict:
    """Stop-and-copy a (quiesced) connection table to host memory in
    ``repro``'s layout: rings ``(R·Q, depth, slot)``, int32 state, the
    same keys (see :func:`qp_snapshot`)."""
    return {k: _host_copy(v, k in _CONN_RING_KEYS) for k, v in conn.items()}


def conn_restore(conn_host: dict, mesh=None, *, axis: str = "rank",
                 device=None) -> dict:
    """A connection-table snapshot (either package's) back into a table on
    ``device``: live migration of every QP at once, retransmission state
    included."""
    return _restore(conn_host, conn_specs(axis=axis), _CONN_RING_KEYS, mesh,
                    axis, device, "connection-table")


__all__ = [
    "QPConfig", "TransportError", "UD_MTU",
    "CQE_EMPTY", "CQE_SEND", "CQE_RECV", "CQE_ERR_RETRY", "CQE_ERR_FATAL",
    "qp_init", "adaptive_rto",
    "post_send", "post_recv", "flush_send", "poll_cq", "windowed_send",
    "qp_specs", "qp_quiesce", "qp_snapshot", "qp_restore",
    "conn_init", "conn_specs", "srq_post", "conn_send",
    "conn_quiesce", "conn_snapshot", "conn_restore",
    "rank_mediate", "rank_complete", "allreduce_state", "cq_occupancy",
]
