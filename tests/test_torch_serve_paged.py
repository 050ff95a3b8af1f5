"""Port parity for the paged KV pool and chunked prefill in the serving
engine, on gemma3-1b smoke.

repro's Engine and repro_torch's are built as tests/test_torch_serve.py
builds them (a ``cord`` dataplane with ``emulate_costs``, tenants
train/alice/bob, a QoS policy on ``train``), with the same parameters,
and serve the same requests at temperature 0 with ``block_size=8`` and/or
``prefill_chunk=8`` and prompts of up to five chunks.  Inside the port,
paged ≡ fixed ≡ gang and chunked ≡ whole prefill; pool pressure and a
preemption mid-chunk resume exactly.  Tolerance: exact — token streams,
tenant reports and counter blocks are equal."""

import jax
import numpy as np
import pytest

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import ServeConfig as JServe
from repro.core.dataplane import Dataplane as JDataplane
from repro.core import policies as jpol
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeError as JServeError

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core import policies as tpol
from repro_torch.core import telemetry as tl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeError

from torch_port_util import jax_params_np, pin_calibration

TENANTS = ("train", "alice", "bob")
# prompts of up to five 8-token chunks, lengths off the chunk grid
LENGTHS = (5, 20, 33, 9, 12, 40)
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=64)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _policies(mod):
    return [mod.TelemetryPolicy(),
            mod.QoSPolicy(rates={"train": 0.25}, burst=2.0, stall_ns=200.0)]


def _requests(cls, lengths=LENGTHS, max_new=6, tenants=None):
    tenants = tenants or [TENANTS[1 + i % 2] for i in range(len(lengths))]
    return [cls(rid=i, prompt=np.asarray((np.arange(n) * 3 + 7 * i) % 97,
                                         np.int32),
                max_new_tokens=max_new, tenant=t)
            for i, (n, t) in enumerate(zip(lengths, tenants))]


def _tokens(done):
    return {r.rid: r.out_tokens for r in done}


def _torch_engine(smoke, **serve):
    _, _, _, tcfg, tm, tp = smoke
    dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                    mesh=make_mesh((8,), ("data",)), tenant="train",
                    tenants=TENANTS, policies=_policies(tpol), device="cpu")
    return TEngine(tm, tp, tcfg, TServe(**{**SERVE, **serve}), dp=dp,
                   eos_id=-1)


def _jax_engine(smoke, mesh8, **serve):
    jcfg, jm, jp, _, _, _ = smoke
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=mesh8,
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))
    return JEngine(jm, jp, jcfg, JServe(**{**SERVE, **serve}), dp=jdp,
                   eos_id=-1)


def _assert_engines_equal(teng, tdone, jeng, jdone):
    assert _tokens(tdone) == _tokens(jdone)
    assert all(r.done for r in tdone) and len(tdone) == len(jdone)
    assert teng.tenant_report() == jeng.tenant_report()
    tctrs, ttenants = teng.runtime_counters()
    jctrs, jtenants = jeng.runtime_counters()
    assert ttenants == jtenants
    np.testing.assert_array_equal(tctrs, jctrs)


def _count_chunks(eng):
    """Count chunk steps on ``eng`` (replay detector)."""
    orig, c = eng._chunk, {"n": 0}

    def wrapped(*a, **kw):
        c["n"] += 1
        return orig(*a, **kw)

    eng._chunk = wrapped
    return c


@pytest.mark.parametrize("serve", [
    dict(block_size=8),
    dict(prefill_chunk=8),
    dict(block_size=8, prefill_chunk=8),
    # pool pressure: 8 blocks cannot hold the 40-token prompt's 5 and a
    # co-resident's growth, so both engines preempt and restore
    dict(block_size=8, prefill_chunk=8, n_blocks=8),
], ids=["paged", "chunked", "paged_chunked", "paged_chunked_pressure"])
def test_engine_matches_jax_through_cord_dataplane(smoke, mesh8, monkeypatch,
                                                   serve):
    pin_calibration(monkeypatch)
    jeng = _jax_engine(smoke, mesh8, **serve)
    jdone = jeng.run(_requests(JRequest))
    teng = _torch_engine(smoke, **serve)
    assert (teng.paged, teng.chunked) == (jeng.paged, jeng.chunked)
    tdone = teng.run(_requests(TRequest))
    _assert_engines_equal(teng, tdone, jeng, jdone)
    assert teng.decode_compile_count() == 1
    if teng.paged:
        assert teng._alloc.free_blocks == teng._n_usable
        assert not teng._tables.any()
    if serve.get("n_blocks"):
        ctrs, _ = teng.runtime_counters()
        assert ctrs[:, tl.CTR_PREEMPTIONS].sum() >= 1
        assert ctrs[:, tl.CTR_RESTORES].sum() >= 1
    assert {r.mode for r in teng.dp.telemetry.records} == {"cord"}


def test_pool_pressure_preempts_like_jax(smoke, mesh8, monkeypatch):
    """Two residents whose decode growth the pool cannot hold: the port
    preempts and restores exactly where repro does."""
    pin_calibration(monkeypatch)
    serve = dict(max_new_tokens=8, block_size=8, n_blocks=3)
    jeng = _jax_engine(smoke, mesh8, **serve)
    jdone = jeng.run(_requests(JRequest, (8, 8), max_new=8))
    teng = _torch_engine(smoke, **serve)
    tdone = teng.run(_requests(TRequest, (8, 8), max_new=8))
    _assert_engines_equal(teng, tdone, jeng, jdone)
    ctrs, _ = teng.runtime_counters()
    assert ctrs[:, tl.CTR_PREEMPTIONS].sum() >= 1
    assert ctrs[:, tl.CTR_RESTORES].sum() >= 1


def test_mid_chunk_preemption_matches_jax(smoke, mesh8, monkeypatch):
    """A slot budget lowered after the first chunk of a long prompt evicts
    it mid-prefill in both engines; both replay its chunks alike."""
    pin_calibration(monkeypatch)
    serve = dict(max_new_tokens=6, kv_cache_len=128, prefill_chunk=16,
                 block_size=8)
    outs = []
    for eng, req in ((_jax_engine(smoke, mesh8, **serve), JRequest),
                     (_torch_engine(smoke, **serve), TRequest)):
        chunks = _count_chunks(eng)
        orig_adv = eng._advance_chunk

        def adv(*a, eng=eng, chunks=chunks, orig_adv=orig_adv):
            out = orig_adv(*a)
            if chunks["n"] == 1:
                eng.set_slot_budget(1)
            return out

        eng._advance_chunk = adv
        done = eng.run(_requests(req, (8, 40), tenants=["alice"] * 2))
        outs.append((eng, done, chunks["n"]))
    (jeng, jdone, jn), (teng, tdone, tn) = outs
    _assert_engines_equal(teng, tdone, jeng, jdone)
    assert tn == jn
    assert teng.tenant_report()["alice"]["preemptions"] >= 1


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------

def test_paged_equals_fixed_equals_gang(smoke):
    lengths = (8,) * 5                   # uniform: gang pads nothing
    fixed = _tokens(_torch_engine(smoke).run(_requests(TRequest, lengths)))
    paged_eng = _torch_engine(smoke, block_size=8)
    paged = _tokens(paged_eng.run(_requests(TRequest, lengths)))
    gang = _tokens(_torch_engine(smoke).run(_requests(TRequest, lengths),
                                            scheduler="gang"))
    assert paged == fixed == gang
    assert paged_eng._decode_shapes == {("pool", 2, 128)}


def test_paged_equals_fixed_mixed_lengths(smoke):
    # a stripe of 128 holds the whole prefill's 64-token bucket of 40
    fixed = _tokens(_torch_engine(smoke, kv_cache_len=128).run(
        _requests(TRequest)))
    paged = _tokens(_torch_engine(smoke, kv_cache_len=128, block_size=8).run(
        _requests(TRequest)))
    assert paged == fixed


def test_chunked_equals_whole_prefill(smoke):
    whole = _tokens(_torch_engine(smoke, kv_cache_len=128).run(
        _requests(TRequest)))
    for serve in (dict(prefill_chunk=8), dict(prefill_chunk=8, block_size=8)):
        eng = _torch_engine(smoke, kv_cache_len=128, **serve)
        chunks = _count_chunks(eng)
        assert eng.chunked
        assert _tokens(eng.run(_requests(TRequest))) == whole
        # every prompt over one chunk is prefilled ceil(n / 8) chunks
        assert chunks["n"] == sum(-(-n // 8) for n in LENGTHS if n > 8)


def test_paged_admits_prompt_longer_than_stripe(smoke):
    base = dict(max_new_tokens=8, kv_cache_len=56)
    with pytest.raises(ServeError, match="cache positions"):
        _torch_engine(smoke, **base).run(_requests(TRequest, (80,), 8))
    with pytest.raises(ServeError, match="gang request"):
        _torch_engine(smoke, **base).run(_requests(TRequest, (80,), 8),
                                         scheduler="gang")
    (done,) = _torch_engine(smoke, **base, block_size=8, n_blocks=24).run(
        _requests(TRequest, (80,), 8))
    assert done.done and len(done.out_tokens) == 8
    with pytest.raises(ServeError, match="pool blocks"):
        _torch_engine(smoke, **base, block_size=8, n_blocks=4).run(
            _requests(TRequest, (80,), 8))


def test_pool_pressure_preempts_and_resumes_exact(smoke):
    base = dict(max_new_tokens=8, block_size=8)
    roomy = _tokens(_torch_engine(smoke, **base).run(
        _requests(TRequest, (8, 8), 8, tenants=["alice"] * 2)))
    tight = _torch_engine(smoke, **base, n_blocks=3)
    out = _tokens(tight.run(_requests(TRequest, (8, 8), 8,
                                      tenants=["alice"] * 2)))
    assert out == roomy
    rep = tight.tenant_report()["alice"]
    assert rep["preemptions"] >= 1 and rep["restores"] >= 1
    assert tight._alloc.free_blocks == 3


def test_preempt_mid_chunk_replays_pending_chunks(smoke):
    base = dict(max_new_tokens=6, kv_cache_len=128, prefill_chunk=16,
                block_size=8)
    reqs = lambda: _requests(TRequest, (8, 40), tenants=["alice"] * 2)  # noqa: E731
    ref = _torch_engine(smoke, **base)
    c_ref = _count_chunks(ref)
    out_ref = _tokens(ref.run(reqs()))

    eng = _torch_engine(smoke, **base)
    c_eng = _count_chunks(eng)
    orig_adv = eng._advance_chunk

    def adv(*a):
        out = orig_adv(*a)
        if c_eng["n"] == 1:              # first chunk landed; rest pending
            eng.set_slot_budget(1)
        return out

    eng._advance_chunk = adv
    assert _tokens(eng.run(reqs())) == out_ref
    assert eng.tenant_report()["alice"]["preemptions"] >= 1
    assert c_eng["n"] > c_ref["n"]       # the pending chunks were replayed
    assert not eng._prefills and not eng._prefill_q
    assert eng._alloc.free_blocks == eng._n_usable


def test_pool_pressure_while_chunked_prefill_pending(smoke):
    base = dict(max_new_tokens=6, kv_cache_len=128, prefill_chunk=16,
                block_size=8)
    reqs = lambda: _requests(TRequest, (8, 40), tenants=["alice"] * 2)  # noqa: E731
    roomy = _torch_engine(smoke, **base)
    out_r = _tokens(roomy.run(reqs()))
    need = -(-roomy._cover(40) // 8)
    tight = _torch_engine(smoke, **base, n_blocks=need + 1)
    assert _tokens(tight.run(reqs())) == out_r
    assert tight.tenant_report()["alice"]["preemptions"] >= 1
    assert tight._alloc.free_blocks == need + 1


def test_hybrid_paged_raises_repro_serve_error():
    jcfg = jget("hymba-1.5b", smoke=True)
    jm = jbuild(jcfg)
    with pytest.raises(JServeError) as jerr:
        JEngine(jm, None, jcfg, JServe(block_size=8, kv_cache_len=64))
    tcfg = tget("hymba-1.5b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    with pytest.raises(ServeError) as terr:
        TEngine(tm, None, tcfg, TServe(block_size=8, kv_cache_len=64))
    assert str(terr.value) == str(jerr.value)
    assert "block_size=0" in str(terr.value)
    # chunked prefill is a no-op for the hybrid family, as in repro
    assert not TEngine(tm, None, tcfg, TServe(prefill_chunk=8)).chunked


@pytest.mark.parametrize("block,chunk,want_chunks", [(16, 512, 0),
                                                     (8, 8, 4)])
def test_launcher_serves_paged_and_chunked(monkeypatch, capsys, block, chunk,
                                           want_chunks):
    """``launch/serve.py --block-size`` serves from the pool; with
    ``--prefill-chunk 8`` its 9- and 10-token prompts (requests 3, 4, 8
    and 9 of 10) take two chunks each instead of a whole prefill."""
    from repro_torch.launch.serve import main
    from repro_torch.serve import engine as engine_mod

    chunks = {"n": 0}
    orig = engine_mod.Engine._chunk

    def counted(self, *a):
        chunks["n"] += 1
        return orig(self, *a)

    monkeypatch.setattr(engine_mod.Engine, "_chunk", counted)
    main(["--block-size", str(block), "--prefill-chunk", str(chunk),
          "--requests", "10", "--max-new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 10 requests, 40 tokens" in out
    assert chunks["n"] == 2 * want_chunks
