"""Port parity for serving the ssm (xlstm-350m smoke) and encdec
(whisper-small smoke) families: repro's Engine and repro_torch's with
the same parameters, through one ``cord`` dataplane with
``emulate_costs`` (tenants train/alice/bob, a QoS policy rate-limiting
``train``), at temperature 0, continuous and gang.  xlstm is recurrent:
every prompt is prefilled at its exact length; whisper's engine prefill
has no frames and encodes the zero window.  A paged pool refuses both
families with ``repro``'s ServeError.  Tolerance: exact — token
streams, tenant reports and counter blocks are equal."""

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
from repro.serve import ServeError as JServeError

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import policies as tpol
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeError

from torch_port_util import jax_params_np, pin_calibration
from torch_port_util import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
TENANTS = ("train", "alice", "bob")
LENGTHS = (5, 11, 6, 5, 11, 6)
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=32)


@pytest.fixture(scope="module", params=["xlstm-350m", "whisper-small"])
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


def _requests(cls):
    return [cls(rid=i, prompt=np.asarray((np.arange(n) * 3 + 7 * i) % 97,
                                         np.int32),
                max_new_tokens=m, tenant=TENANTS[1 + i % 2])
            for i, (n, m) in enumerate(zip(LENGTHS, (6, 4, 6, 5, 6, 3)))]


@pytest.mark.parametrize("scheduler", ["continuous", "gang"])
def test_engine_matches_jax_through_cord_dataplane(smoke, mesh8, monkeypatch,
                                                   scheduler):
    pin_calibration(monkeypatch)
    jcfg, jm, jp, tcfg, tm, tp = smoke
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=mesh8,
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))
    jeng = JEngine(jm, jp, jcfg, JServe(**SERVE), dp=jdp, eos_id=-1)
    jdone = jeng.run(_requests(JRequest), scheduler=scheduler)
    tdp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                     mesh=make_mesh((8,), ("data",)), tenant="train",
                     tenants=TENANTS, policies=_policies(tpol), device="cpu")
    teng = TEngine(tm, tp, tcfg, TServe(**SERVE), dp=tdp, eos_id=-1)
    tdone = teng.run(_requests(TRequest), scheduler=scheduler)
    assert {r.rid: r.out_tokens for r in tdone} == \
        {r.rid: r.out_tokens for r in jdone}
    assert all(r.done for r in tdone) and len(tdone) == len(LENGTHS)
    assert teng.tenant_report() == jeng.tenant_report()
    tctrs, ttenants = teng.runtime_counters()
    jctrs, jtenants = jeng.runtime_counters()
    assert ttenants == jtenants
    np.testing.assert_array_equal(tctrs, jctrs)
    family_tags = {"xlstm-350m": {"mlstm/inner", "slstm/out"},
                   "whisper-small": {"enc/in", "layer/out"}}[jcfg.name[:-6]]
    assert family_tags <= set(teng.dp.telemetry.by_tag())


def test_paged_pool_refuses_the_family(smoke):
    jcfg, jm, jp, tcfg, tm, tp = smoke
    with pytest.raises(JServeError) as jerr:
        JEngine(jm, jp, jcfg, JServe(**SERVE, block_size=8))
    with pytest.raises(ServeError) as terr:
        TEngine(tm, tp, tcfg, TServe(**SERVE, block_size=8))
    assert str(terr.value) == str(jerr.value)
