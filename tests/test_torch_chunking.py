"""Port parity for chunked collective scheduling
(``repro_torch.core.chunking``): ``chunked_psum`` and ``schedule_batch``
against ``repro``'s.

Tolerance: exact.  ``chunked_psum`` of a rank-stacked payload equals
``dp.psum`` of it bit for bit (each element is the same sum in rank
order), and its runtime report (ops, bytes, chunks, throttled,
kernel_iters) equals ``repro``'s for the same chunks under the same QoS
bucket; ``schedule_batch`` issues in priority order and returns results
in the original order."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import DataplaneConfig as JCfg
from repro.core import compat
from repro.core import policies as jpol
from repro.core.chunking import chunked_psum as jchunked
from repro.core.dataplane import Dataplane as JDataplane

from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.core import policies as tpol
from repro_torch.core.chunking import chunked_psum, schedule_batch
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh

from torch_port_util import bits, cuda_device, pin_calibration

TENANTS = ("train", "alice", "bob")


def _policies(m, qos: bool):
    pols = [m.TelemetryPolicy()]
    if qos:
        pols.append(m.QoSPolicy(rates={"train": 0.25}, burst=2.0,
                                stall_ns=200.0))
    return pols


def _dataplanes(mesh8, qos: bool, emulate: bool):
    kw = dict(mode="cord", emulate_costs=emulate)
    jdp = JDataplane(JCfg(**kw), mesh=mesh8, tenant="train",
                     tenants=TENANTS, policies=_policies(jpol, qos))
    tdp = TDataplane(TCfg(**kw), mesh=make_mesh((8,), ("data",)),
                     tenant="train", tenants=TENANTS,
                     policies=_policies(tpol, qos), device="cpu")
    return jdp, tdp


@pytest.mark.parametrize("rows,num_chunks", [(8, 4), (6, 4), (5, 1)])
def test_chunked_psum_equals_psum(rows, num_chunks):
    """Bit for bit the whole psum, tail padding sliced off."""
    tdp = TDataplane(TCfg(mode="cord"), mesh=make_mesh((8,), ("data",)),
                     device="cpu")
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (8, rows, 4)).astype(np.float32))
    whole, _ = tdp.psum(x, "data")
    chunked, _ = chunked_psum(tdp, x, "data", num_chunks=num_chunks)
    assert chunked.shape == x.shape
    np.testing.assert_array_equal(bits(chunked), bits(whole))


@pytest.mark.parametrize("qos,emulate", [(False, False), (True, False),
                                         (True, True)])
def test_chunked_psum_report_matches_jax(mesh8, monkeypatch, qos, emulate):
    """Ops, bytes, chunks, throttled and kernel_iters as ``repro``'s, for
    two chunked psums under the train tenant's bucket (tail padded)."""
    pin_calibration(monkeypatch)
    jdp, tdp = _dataplanes(mesh8, qos, emulate)
    x = np.random.default_rng(1).standard_normal((8 * 6, 4)).astype(
        np.float32)

    @partial(compat.shard_map, mesh=mesh8, in_specs=(JP("data"), JP()),
             out_specs=(JP("data"), JP()))
    def f(v, rt):
        out, rt = jchunked(jdp, v, "data", num_chunks=4, state=rt)
        out, rt = jchunked(jdp, out, "data", num_chunks=4, state=rt)
        return out, rt

    jout, jrt = jax.jit(f)(jnp.asarray(x), jdp.runtime_init())
    trt = tdp.runtime_init()
    tx = torch.from_numpy(x.reshape(8, 6, 4).copy())
    tout, trt = chunked_psum(tdp, tx, "data", num_chunks=4, state=trt)
    tout, trt = chunked_psum(tdp, tout, "data", num_chunks=4, state=trt)
    np.testing.assert_array_equal(bits(tout[0]),
                                  bits(np.asarray(jout)[:6]))
    rep = tdp.runtime_report(trt)
    assert rep == jdp.runtime_report(jrt)
    assert rep["train"]["ops"] == 8 and rep["train"]["chunks"] == 8
    assert (rep["train"]["throttled"] > 0) == qos
    tags = [r.tag for r in tdp.telemetry.records]
    assert tags == [f"chunked_psum/chunk{i}" for i in range(4)] * 2
    assert all(r.precharged == qos for r in tdp.telemetry.records)


def test_schedule_batch_issues_by_priority_returns_in_order():
    qos = tpol.QoSPolicy(classes={"hi": 0, "lo": 9})
    issued = []

    def op(cls, v):
        def thunk():
            issued.append(v)
            return torch.tensor(v)
        return (cls, thunk)

    outs = schedule_batch(qos, [op("lo", 1.0), op("hi", 2.0), op("lo", 3.0),
                                op("other", 4.0)])
    assert [float(o) for o in outs] == [1.0, 2.0, 3.0, 4.0]
    assert issued == [2.0, 1.0, 3.0, 4.0]
    assert qos.priority("hi") == 0 and qos.priority("nope") == 100
    issued.clear()
    schedule_batch(None, [op("lo", 1.0), op("hi", 2.0)])
    assert issued == [1.0, 2.0]


def test_qos_governs_and_chunk_hook():
    qos = tpol.QoSPolicy(rates={"train": 0.25, "idle": 0.0})
    assert qos.governs("train") and not qos.governs("idle")
    assert not qos.governs("alice")


@pytest.mark.cuda
def test_chunked_psum_bit_for_bit_on_card():
    """On the card, under the QoS bucket and with cost emulation: the same
    bits as ``psum``, no stream sync, the report's counts as the CPU's."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 1000, 64), generator=gen, device=dev)
    reports = {}
    for d in (dev, torch.device("cpu")):
        tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                         mesh=make_mesh((2,), ("data",)), tenant="train",
                         tenants=TENANTS, policies=_policies(tpol, True),
                         device=d)
        rt = tdp.runtime_init()
        xd = x.to(d)
        whole, _ = tdp.psum(xd, "data")
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, rt = chunked_psum(tdp, xd, "data", num_chunks=4, state=rt)
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        np.testing.assert_array_equal(bits(out), bits(whole))
        rep = tdp.runtime_report(rt)["train"]
        reports[d.type] = {k: rep[k] for k in ("ops", "bytes", "chunks",
                                               "throttled")}
    assert reports["cuda"] == reports["cpu"]
    assert reports["cuda"]["chunks"] == 4
