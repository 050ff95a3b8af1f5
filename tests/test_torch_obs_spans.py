"""The span recorder of ``repro_torch.core.obs`` and its sites in the
engine, the MoE layer, the dataplane and the explicit-DP train step, on
the CPU at smoke size.

Spans record only while a ``torch.profiler`` session records; they never
change a result.  The serving cases run grok-1's smoke config (GeGLU
experts) on the paged pool with chunked prefill, through a ``cord``
dataplane with telemetry, on a pool tight enough to preempt.  Tolerance:
exact — served tokens and trained parameters are bit-identical with
tracing on and off."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_model_config
from repro_torch.configs.base import (DataplaneConfig, MoEConfig, RunConfig,
                                      ServeConfig, TrainConfig)
from repro_torch.core import (Dataplane, QoSPolicy, TelemetryPolicy,
                              clear_spans, record_span, recorded_spans,
                              span, tracing)
from repro_torch.core import techniques
from repro_torch.core.tree import tree_flatten
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers.moe import moe, moe_init
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request
from repro_torch.train import make_explicit_dp_step, state_from_params

TENANTS = ("train", "alice", "bob")
LENGTHS = (8, 40, 12)
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=128,
             prefill_chunk=16, block_size=8)
DEVICE_TIMED = ("moe.cast", "engine.kv_gather", "train.adamw")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """One intra-op thread, a pinned delay calibration, no spans left by
    another test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(techniques._CALIBRATION, ("cpu", 200_000), 1.0)
    clear_spans()
    yield
    clear_spans()
    torch.set_num_threads(n)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _dataplane(ranks: int = 8) -> Dataplane:
    return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                     mesh=make_mesh((ranks,), ("data",)), tenant="train",
                     tenants=TENANTS,
                     policies=[TelemetryPolicy(),
                               QoSPolicy(rates={"train": 0.25}, burst=2.0,
                                         stall_ns=200.0)],
                     device="cpu")


@pytest.fixture(scope="module")
def grok():
    cfg = get_model_config("grok-1-314b", smoke=True)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _serve(grok, traced: bool):
    """Serve LENGTHS on a pool of 7 blocks, one over the 40-token prompt's
    48-position chunk cover, so that pool pressure preempts; the engine,
    what it served, the edges its dataplane recorded and its prefill
    chunks (which run outside the engine's spans)."""
    cfg, model, params = grok
    dp = _dataplane()
    eng = Engine(model, params, cfg, ServeConfig(**SERVE, n_blocks=7), dp=dp)
    chunks = [0]
    chunk = eng._chunk

    def counted(*args):
        chunks[0] += 1
        return chunk(*args)
    eng._chunk = counted
    reqs = [Request(rid=10 + i, prompt=np.asarray(
        (np.arange(n) * 3 + 7 * i) % 97, np.int32), max_new_tokens=6,
        tenant="alice") for i, n in enumerate(LENGTHS)]
    n0 = sum(v["ops"] for v in dp.telemetry.by_kind().values())
    done = _profiled(lambda: eng.run(reqs)) if traced else eng.run(reqs)
    edges = sum(v["ops"] for v in dp.telemetry.by_kind().values()) - n0
    return eng, {r.rid: list(r.out_tokens) for r in done}, edges, chunks[0]


@pytest.fixture(scope="module")
def served(grok):
    clear_spans()
    eng, tokens, edges, chunks = _serve(grok, traced=True)
    spans = recorded_spans()
    clear_spans()
    return eng, tokens, edges, spans, chunks


def _lineage(spans, s):
    by_id = {x.id: x for x in spans}
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


def test_nothing_records_without_a_profiler(grok):
    assert not tracing()
    with span("outer") as s:
        s.note(bytes=1)
    record_span("engine.queue", 0, 1, rid=1)
    _serve(grok, traced=False)
    assert recorded_spans() == []


def test_recorder_nests_and_clears():
    def work():
        assert tracing()
        with span("outer", rid=3, tokens=2) as s:
            s.note(bytes=8)
            with span("inner", device=torch.device("cpu")):
                pass
        record_span("engine.queue", 5, 9, rid=3, tenant="alice")
    _profiled(work)
    outer, inner, queue = recorded_spans()
    assert (outer.name, outer.parent, outer.rid) == ("outer", None, 3)
    assert outer.attrs == {"tokens": 2, "bytes": 8}
    assert inner.parent == outer.id and inner.device_ms is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert (queue.parent, queue.start_ns, queue.end_ns) == (None, 5, 9)
    clear_spans()
    assert recorded_spans() == []


def test_profiler_leaves_served_tokens_alone(grok, served):
    eng, tokens, _, _, _ = served
    plain, plain_tokens, _, _ = _serve(grok, traced=False)
    assert tokens == plain_tokens
    assert eng.tenant_report() == plain.tenant_report()
    assert eng.tenant_report()["alice"]["preemptions"] >= 1


def test_queue_span_per_grant(served):
    eng, tokens, _, spans, _ = served
    queue = Counter(s.rid for s in spans if s.name == "engine.queue")
    preempted = eng.tenant_report()["alice"]["preemptions"]
    assert set(queue) == set(tokens)
    assert sum(queue.values()) == len(tokens) + preempted
    for s in spans:
        if s.name == "engine.queue":
            assert s.parent is None and s.end_ns >= s.start_ns
            assert s.attrs["tenant"] == "alice" and s.attrs["prompt"] > 0
    assert not any(s.parent is not None and s.parent in
                   {q.id for q in spans if q.name == "engine.queue"}
                   for s in spans)


@pytest.mark.parametrize("name,holders,in_chunks", [
    ("dataplane.edge", {"engine.tick", "engine.prefill"}, True),
    ("engine.kv_gather", {"engine.tick"}, False),
    ("engine.kv_scatter", {"engine.tick"}, False),
    ("moe.cast", {"engine.tick", "engine.prefill"}, True),
])
def test_spans_nest_in_their_engine_step(served, name, holders, in_chunks):
    """Each span lies inside its engine step; a model call's spans may
    instead lie outside every engine span, where a prefill chunk runs."""
    spans = served[3]
    mine = [s for s in spans if s.name == name]
    assert mine
    for s in mine:
        lineage = _lineage(spans, s)
        assert holders & set(lineage) or (in_chunks and not any(
            n.startswith("engine.") for n in lineage)), (name, lineage)
    by_id = {x.id: x for x in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_edge_spans_equal_recorded_edges(served):
    _, _, edges, spans, _ = served
    mine = [s for s in spans if s.name == "dataplane.edge"]
    assert len(mine) == edges > 0
    assert all(s.attrs["kind"] == "constraint" and s.attrs["bytes"] > 0
               and s.attrs["tag"] for s in mine)


def test_casts_three_per_layer_call(grok, served):
    cfg = grok[0]
    spans, chunks = served[3], served[4]
    calls = sum(s.name in ("engine.prefill", "engine.tick") for s in spans)
    casts = Counter(s.attrs["leaf"] for s in spans if s.name == "moe.cast")
    assert chunks > 0
    assert casts == {leaf: cfg.num_layers * (calls + chunks)
                     for leaf in ("wi", "wg", "wo")}
    in_chunks = [s for s in spans if s.name == "moe.cast" and not any(
        n.startswith("engine.") for n in _lineage(spans, s))]
    assert len(in_chunks) == 3 * cfg.num_layers * chunks
    prefills = [s for s in spans if s.name == "engine.prefill"]
    assert prefills and {s.rid for s in prefills} <= set(served[1])
    assert all(s.attrs["tokens"] > 0 for s in prefills)


@pytest.mark.parametrize("gated,leaves", [(True, ("wi", "wg", "wo")),
                                          (False, ("wi", "wo"))])
def test_moe_layer_casts_each_expert_leaf(gated, leaves):
    gen = torch.Generator().manual_seed(0)
    cfg = MoEConfig(num_experts=4, top_k=2)
    params = moe_init(gen, 16, 32, cfg, gated=gated)
    params = {k: v.to(torch.bfloat16) if k != "router" else v
              for k, v in params.items()}
    x = torch.randn(2, 5, 16, generator=gen)
    plain, _ = moe(params, x, cfg)
    traced, _ = _profiled(lambda: moe(params, x, cfg))
    assert torch.equal(plain, traced)
    casts = [s for s in recorded_spans() if s.name == "moe.cast"]
    assert tuple(s.attrs["leaf"] for s in casts) == leaves
    assert all(s.device_ms is None for s in casts)


def test_device_timed_spans_read_none_on_the_cpu(served):
    spans = served[3]
    for name in DEVICE_TIMED[:2]:
        assert [s.device_ms for s in spans if s.name == name] and all(
            s.device_ms is None for s in spans if s.name == name)


def _train_step(traced: bool):
    cfg = get_model_config("gemma3-1b", smoke=True)
    model = build_model(cfg, device="cpu")
    dp = _dataplane(ranks=2)
    step = make_explicit_dp_step(
        model, RunConfig(train=TrainConfig(warmup_steps=1)), dp,
        runtime_accounting=True)
    state = state_from_params(model.init(0))
    gen = torch.Generator().manual_seed(1)
    rows = torch.randint(0, cfg.vocab_size, (4, 17), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": rows[:, :-1].contiguous(),
             "labels": rows[:, 1:].contiguous()}
    rt = dp.runtime_init()
    if traced:
        state, _, rt = _profiled(lambda: step(state, batch, rt))
    else:
        state, _, rt = step(state, batch, rt)
    return state


def test_train_step_bit_identical_and_spanned():
    plain = _train_step(traced=False)
    assert recorded_spans() == []
    traced = _train_step(traced=True)
    for (path, a), (_, b) in zip(tree_flatten(plain.params),
                                 tree_flatten(traced.params)):
        assert torch.equal(a, b), path
    spans = recorded_spans()
    names = Counter(s.name for s in spans)
    assert names["train.rank_grads"] == 2 and names["train.adamw"] == 1
    assert names["dataplane.edge"] > 0
    ranks = [s for s in spans if s.name == "train.rank_grads"]
    assert [s.attrs["rank"] for s in ranks] == [0, 1]
    (adamw,) = [s for s in spans if s.name == "train.adamw"]
    assert adamw.device_ms is None and adamw.parent is None
    for s in spans:                  # the gradient sync's edges
        if s.name == "dataplane.edge":
            assert s.parent is None
            assert ranks[-1].end_ns <= s.start_ns <= s.end_ns <= \
                adamw.start_ns
