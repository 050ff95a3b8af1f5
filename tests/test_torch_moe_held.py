"""The serving engine's held copy of the MoE experts, on the CPU at smoke
size: ``layers/moe.held_experts`` casts the expert leaves once and shares
every other leaf; grok-1's smoke config computed in bfloat16 over float32
parameters serves the same tokens and logits, bit for bit, from the held
copy and from the per-call cast; the copy follows the caller's weights
when they change; the ``moe.cast`` spans say which path ran.

Tolerance: exact."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.serve.engine as engine_mod
from repro_torch.configs import get_model_config
from repro_torch.configs.base import ServeConfig
from repro_torch.core import clear_spans, recorded_spans
from repro_torch.core.tree import tree_flatten
from repro_torch.layers.moe import held_bytes, held_experts
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request

LENGTHS = (5, 20, 33, 9)
SERVES = {
    "stripe": dict(max_batch=2, max_new_tokens=6, kv_cache_len=128,
                   prefill_chunk=0),
    "paged_chunked": dict(max_batch=2, max_new_tokens=6, kv_cache_len=64,
                          block_size=8, prefill_chunk=16),
    "gang": dict(max_batch=2, max_new_tokens=6, kv_cache_len=64,
                 prefill_chunk=0, scheduler="gang"),
}
EXPERTS = ("wi", "wg", "wo")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    clear_spans()
    yield
    clear_spans()
    torch.set_num_threads(n)


def _smoke(arch, dtype=None):
    cfg = get_model_config(arch, smoke=True)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


@pytest.fixture(scope="module")
def grok_bf16():
    return _smoke("grok-1-314b", "bfloat16")


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_held_experts_casts_only_the_expert_leaves(arch):
    _, _, params = _smoke(arch)
    before = [(p, t, t.dtype, t._version) for p, t in tree_flatten(params)]
    held = held_experts(params, torch.bfloat16)
    moe, src = held["layers"]["moe"], params["layers"]["moe"]
    for (path, t, dtype, version), (hpath, h) in zip(before,
                                                     tree_flatten(held)):
        assert hpath == path
        assert t.dtype == dtype == torch.float32 and t._version == version
        if path[-2] == "moe" and path[-1] in EXPERTS:
            assert h.dtype == torch.bfloat16 and h is not t
            assert torch.equal(h, t.to(torch.bfloat16))
        else:
            assert h is t
    # the caller's tree is untouched: its dicts still hold its own leaves
    assert [(p, t) for p, t, _, _ in before] == list(tree_flatten(params))
    assert held is not params and moe is not src
    for k in params:
        if k != "layers":
            assert held[k] is params[k]
    assert held["layers"]["attn"] is params["layers"]["attn"]
    if "dense" in src:
        assert moe["dense"] is src["dense"]
    assert held_bytes(params, torch.bfloat16) == sum(
        src[k].numel() * 2 for k in EXPERTS if k in src)


@pytest.mark.parametrize("arch", ["grok-1-314b", "gemma3-1b"])
def test_held_experts_copies_nothing_when_dtypes_agree(arch):
    _, _, params = _smoke(arch)
    assert held_experts(params, torch.float32) is params
    assert held_bytes(params, torch.float32) == 0
    if arch == "gemma3-1b":        # no moe subtree: nothing to hold
        assert held_experts(params, torch.bfloat16) is params


def _requests():
    return [Request(rid=i, prompt=np.asarray((np.arange(n) * 3 + 7 * i) % 97,
                                             np.int32), max_new_tokens=6)
            for i, n in enumerate(LENGTHS)]


def _run(eng, monkeypatch):
    """``eng.run`` of the requests: (tokens by rid, every sampled logits
    row)."""
    sampled = []
    plain = engine_mod.sample

    def kept(logits, gen, temperature):
        sampled.append(logits.clone())
        return plain(logits, gen, temperature)
    monkeypatch.setattr(engine_mod, "sample", kept)
    done = eng.run(_requests())
    monkeypatch.setattr(engine_mod, "sample", plain)
    return {r.rid: list(r.out_tokens) for r in done}, sampled


def _serve(smoke, monkeypatch, serve, *, fits=True, params=None):
    """A new engine's run of the requests: (tokens by rid, every sampled
    logits row, the engine)."""
    cfg, model, p = smoke
    monkeypatch.setattr(engine_mod, "_copy_fits", lambda n, dev: fits)
    eng = Engine(model, p if params is None else params, cfg,
                 ServeConfig(**serve), eos_id=-1)
    return (*_run(eng, monkeypatch), eng)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_held_copy_serves_the_per_call_cast_bit_for_bit(grok_bf16,
                                                        monkeypatch, serve):
    held_tokens, held_logits, eng = _serve(grok_bf16, monkeypatch,
                                           SERVES[serve])
    assert eng._held["layers"]["moe"]["wi"].dtype == torch.bfloat16
    cast_tokens, cast_logits, eng = _serve(grok_bf16, monkeypatch,
                                           SERVES[serve], fits=False)
    assert eng._held is eng.params
    assert held_tokens == cast_tokens
    assert len(held_tokens) == len(LENGTHS)
    assert held_logits and _same(held_logits, cast_logits)


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_in_place_update_is_served_on_the_next_run(grok_bf16, monkeypatch,
                                                   serve):
    cfg, model, _ = grok_bf16
    params, new = model.init(0), model.init(1)
    serve = SERVES[serve]
    _, old, _ = _serve(grok_bf16, monkeypatch, serve, params=params)
    moe, experts = params["layers"]["moe"], {
        k: new["layers"]["moe"][k] for k in EXPERTS}
    _, want, _ = _serve(grok_bf16, monkeypatch, serve, params={
        **params, "layers": {**params["layers"], "moe": {**moe, **experts}}})
    assert not _same(old, want)
    eng = Engine(model, params, cfg, ServeConfig(**serve), eos_id=-1)
    assert _same(_run(eng, monkeypatch)[1], old)
    for k in EXPERTS:
        moe[k].copy_(experts[k])
    assert _same(_run(eng, monkeypatch)[1], want)
    assert torch.equal(eng._held["layers"]["moe"]["wo"],
                       experts["wo"].to(torch.bfloat16))


def test_reassigned_params_are_served_on_the_next_run(grok_bf16,
                                                      monkeypatch):
    cfg, model, params = grok_bf16
    other = model.init(1)
    serve = SERVES["paged_chunked"]
    _, want, _ = _serve(grok_bf16, monkeypatch, serve, params=other)
    eng = Engine(model, params, cfg, ServeConfig(**serve), eos_id=-1)
    assert not _same(_run(eng, monkeypatch)[1], want)
    eng.params = other
    assert eng.params is other and eng._held is None
    assert _same(_run(eng, monkeypatch)[1], want)
    # a leaf replaced inside the caller's dict is seen too
    eng.params = params
    eng.run(_requests())
    moe = params["layers"]["moe"]
    moe["wg"] = other["layers"]["moe"]["wg"].clone()
    eng.run(_requests())
    assert torch.equal(eng._held["layers"]["moe"]["wg"],
                       moe["wg"].to(torch.bfloat16))
    held = eng._held
    eng.run(_requests())
    assert eng._held is held         # nothing changed: the copy is kept


def test_serving_product_in_place_equals_the_autograd_product():
    """The gated experts' product runs in place of the activation only
    where autograd keeps neither factor; both give the same bits."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.layers.moe import moe, moe_init
    gen = torch.Generator().manual_seed(3)
    cfg = MoEConfig(num_experts=4, top_k=2)
    params = held_experts({"moe": moe_init(gen, 16, 32, cfg)},
                          torch.bfloat16)["moe"]
    x = torch.randn(2, 7, 16, generator=gen).to(torch.bfloat16)
    served, _ = moe(params, x, cfg, act="gelu")
    leaves = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in params.items()}
    trained, _ = moe(leaves, x, cfg, act="gelu")
    assert trained.requires_grad and not served.requires_grad
    assert torch.equal(served, trained.detach())
    trained.float().sum().backward()
    assert all(v.grad is not None for v in leaves.values())


@pytest.mark.parametrize("serve", ["paged_chunked", "stripe"])
@pytest.mark.parametrize("fits", [True, False])
def test_cast_spans_say_whether_the_leaf_was_held(grok_bf16, monkeypatch,
                                                  fits, serve):
    cfg, model, params = grok_bf16
    monkeypatch.setattr(engine_mod, "_copy_fits", lambda n, dev: fits)
    eng = Engine(model, params, cfg, ServeConfig(**SERVES[serve]),
                 eos_id=-1)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run(_requests())
    casts = [s for s in recorded_spans() if s.name == "moe.cast"]
    assert casts and {s.attrs["leaf"] for s in casts} == set(EXPERTS)
    assert {s.attrs["held"] for s in casts} == {fits}


@pytest.mark.parametrize("nbytes,fits", [(20, True), (21, False), (0, True)])
def test_copy_fits_leaves_as_much_again(monkeypatch, nbytes, fits):
    """On the card the copy needs twice its size available: free memory
    (30 here) plus what the allocator holds unallocated (12 - 2)."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (30, 100))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 12)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 2)
    assert engine_mod._copy_fits(nbytes, torch.device("cuda", 0)) is fits
    assert engine_mod._copy_fits(10**18, torch.device("cpu"))
