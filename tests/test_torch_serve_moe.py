"""Port parity for serving the moe and vlm families on the engine: the
smoke configs of grok-1-314b, arctic-480b and llava-next-34b (served
text-only, as ``repro``'s engine serves it) through a ``cord`` dataplane
with ``emulate_costs`` and a QoS bucket, against ``repro``'s engine on
the same parameters and requests; then the port's own invariants:
continuous ≡ gang on uniform prompts, exact preempt / resume, paged ≡
fixed stripes, chunked ≡ whole prefill.

Tolerance: exact — temperature-0 token streams, tenant reports and
counter blocks are equal."""

import jax
import numpy as np
import pytest

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import ServeConfig as JServe
from repro.core import policies as jpol
from repro.core.dataplane import Dataplane as JDataplane
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import CounterTimeline
from repro_torch.core import policies as tpol
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest

from torch_port_util import jax_params_np, pin_calibration
from torch_port_util import one_thread  # noqa: F401 (fixture)

ARCHS = ("grok-1-314b", "arctic-480b", "llava-next-34b")
TENANTS = ("train", "alice", "bob")
LENGTHS = (5, 9, 12, 3, 16, 7)
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=32)
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    jcfg = jget(request.param, smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget(request.param, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _policies(mod):
    return [mod.TelemetryPolicy(),
            mod.QoSPolicy(rates={"train": 0.25}, burst=2.0, stall_ns=200.0)]


def _requests(cls, lengths=LENGTHS, max_new=(6, 4, 6, 5, 6, 3),
              tenants=None):
    tenants = tenants or [TENANTS[1 + i % 2] for i in range(len(lengths))]
    return [cls(rid=i, prompt=np.asarray((np.arange(n) * 3 + 7 * i) % 97,
                                         np.int32),
                max_new_tokens=m, tenant=t)
            for i, (n, m, t) in enumerate(zip(lengths, max_new, tenants))]


def _tokens(done):
    return {r.rid: r.out_tokens for r in done}


def _torch_engine(smoke, obs=None, **serve):
    _, _, _, tcfg, tm, tp = smoke
    dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                    mesh=make_mesh((8,), ("data",)), tenant="train",
                    tenants=TENANTS, policies=_policies(tpol), device="cpu")
    return TEngine(tm, tp, tcfg, TServe(**{**SERVE, **serve}), dp=dp,
                   eos_id=-1, obs=obs)


def test_engine_matches_jax_through_cord_dataplane(smoke, mesh8,
                                                   monkeypatch):
    pin_calibration(monkeypatch)
    jcfg, jm, jp, _, _, _ = smoke
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=mesh8,
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))
    jeng = JEngine(jm, jp, jcfg, JServe(**SERVE), dp=jdp, eos_id=-1)
    jdone = jeng.run(_requests(JRequest))
    teng = _torch_engine(smoke)
    tdone = teng.run(_requests(TRequest))
    assert _tokens(tdone) == _tokens(jdone)
    assert all(r.done for r in tdone) and len(tdone) == len(LENGTHS)
    assert teng.tenant_report() == jeng.tenant_report()
    tctrs, ttenants = teng.runtime_counters()
    jctrs, jtenants = jeng.runtime_counters()
    assert ttenants == jtenants
    np.testing.assert_array_equal(tctrs, jctrs)
    tags = {r.tag for r in teng.dp.telemetry.records}
    if smoke[3].family == "moe":
        assert {"moe/dispatch", "moe/expert_in", "moe/out"} <= tags


def test_continuous_equals_gang_uniform_prompts(smoke):
    lengths = (8,) * 5
    out_c = _tokens(_torch_engine(smoke).run(_requests(TRequest, lengths),
                                             scheduler="continuous"))
    out_g = _tokens(_torch_engine(smoke).run(_requests(TRequest, lengths),
                                             scheduler="gang"))
    assert out_c == out_g


def test_budget_preemption_resumes_exactly(smoke):
    want = _tokens(_torch_engine(smoke).run(_requests(TRequest)))
    eng = _torch_engine(smoke, obs=CounterTimeline(source="squeeze"))

    def squeeze(e):
        if e._obs_tick_no == 2:
            e.set_slot_budget(1)

    eng.on_tick = squeeze
    got = _tokens(eng.run(_requests(TRequest,
                                    tenants=["alice"] * len(LENGTHS))))
    assert got == want
    rep = eng.tenant_report()["alice"]
    assert rep["preemptions"] >= 1 and rep["restores"] >= 1


def test_paged_equals_fixed(smoke):
    lengths = (5, 20, 9, 12)
    fixed = _tokens(_torch_engine(smoke, kv_cache_len=64).run(
        _requests(TRequest, lengths)))
    paged = _tokens(_torch_engine(smoke, kv_cache_len=64, block_size=8).run(
        _requests(TRequest, lengths)))
    assert paged == fixed


def test_chunked_equals_whole_prefill(smoke):
    lengths = (5, 20, 33, 9)
    whole = _tokens(_torch_engine(smoke, kv_cache_len=128).run(
        _requests(TRequest, lengths)))
    eng = _torch_engine(smoke, kv_cache_len=128, prefill_chunk=8)
    assert eng.chunked
    assert _tokens(eng.run(_requests(TRequest, lengths))) == whole


@pytest.mark.parametrize("arch", ["grok-1-314b", "llava-next-34b"])
def test_serve_launcher_serves_the_smoke_config(arch):
    """``python -m repro_torch.launch.serve --arch ...`` serves the smoke
    config, as ``repro``'s launcher does: every request finishes with
    in-vocab tokens."""
    from repro_torch.launch.serve import main as serve_main
    eng, done, timeline = serve_main(["--arch", arch, "--device", "cpu",
                                      "--requests", "3",
                                      "--max-new-tokens", "4"])
    vocab = tget(arch, smoke=True).vocab_size
    assert len(done) == 3 and timeline is None
    assert all(r.done and len(r.out_tokens) == 4
               and all(0 <= t < vocab for t in r.out_tokens) for r in done)
