"""The port's examples (``repro_torch.examples``) against ``repro``'s
(``examples/*.py``), each ``repro`` example run as it is, its objects
observed through the names it imports.

Tolerances:
* serve_lm: exact; the temperature-0 tokens of every request on the
  parameters ``repro``'s example draws, converted (``models/convert.py``);
* quickstart: each step's loss at float32 2e-5 relative over the first 3
  steps of the example's 20-step schedule, and one port step's telemetry
  records equal to one trace of ``repro``'s step (``repro`` records an
  op when its step is traced, the port when the op runs);
* train_lm: ``CFG_100M`` cut to 2 layers of d_model 64, 4 steps with
  ``--inject-failure``: the losses at 1e-4 relative, the tolerance
  ``tests/test_torch_train_step.py`` holds int8 compression to, and the
  failures, restores and steps exactly;
* policy_demo: exact; every printed line of the four acts, but for those
  that read the wall clock (``ops_s``, ``bytes_s``) and the quota
  refusal's byte count, which counts executed ops in the port and traced
  ones in ``repro``: the refusal comes at the same iteration of the
  loop."""

import builtins
import dataclasses
import importlib.util
import pathlib
import re

import jax
import numpy as np

from repro.configs import get_model_config as jget
from repro.models import build_model as jbuild

from repro_torch.configs import get_model_config as tget
from repro_torch.examples import policy_demo, quickstart, serve_lm, train_lm
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.runtime import FaultInjector

from torch_port_util import jax_params_np, one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_params(arch: str = "gemma3-1b"):
    """``repro``'s smoke parameters from ``PRNGKey(0)``, as its examples
    draw them, and the port's model holding a converted copy."""
    jparams = jbuild(jget(arch, smoke=True)).init(jax.random.PRNGKey(0))
    tcfg = tget(arch, smoke=True)
    tm = tbuild(tcfg, device="cpu")
    return tm, from_jax_params(jax_params_np(jparams), tcfg, device="cpu")


def test_serve_lm_tokens_equal_repro(capsys, one_thread):  # noqa: F811
    _jax_example("serve_lm").main()
    want = capsys.readouterr().out.splitlines()
    tm, tp = _smoke_params()
    res = serve_lm.run(tm, tp)
    got = capsys.readouterr().out.splitlines()
    # the 10 requests' tokens; the first line holds the wall-clock rate
    assert got[1:] == want[1:] and len(got) == 5
    assert res["tokens"] == 160 and len(res["done"]) == 10
    assert got[0].startswith("10 requests, 160 tokens in ")


def test_quickstart_steps_and_records_equal_repro(monkeypatch, capsys,
                                                  one_thread):  # noqa: F811
    jex = _jax_example("quickstart")
    jlosses, jdps = [], []
    make_step, make_dp = jex.make_explicit_dp_step, jex.Dataplane

    def step_maker(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            jlosses.append(float(metrics["loss"]))
            return state, metrics
        return recorded

    monkeypatch.setattr(jex, "make_explicit_dp_step", step_maker)
    monkeypatch.setattr(jex, "Dataplane",
                        lambda *a, **k: jdps.append(make_dp(*a, **k))
                        or jdps[-1])
    monkeypatch.setattr(jex, "range", lambda n: builtins.range(min(n, 3)),
                        raising=False)
    jex.main()
    tm, tp = _smoke_params()
    res = quickstart.run(tm, tp, steps=3)
    np.testing.assert_allclose(res["losses"], jlosses, rtol=2e-5)
    out = capsys.readouterr().out
    assert out.count("step   0  loss") == 2

    def records(dp):
        return [(r.kind, r.tag, r.bytes, r.shape, r.dtype, r.qos)
                for r in dp.telemetry.records]
    one_trace = records(jdps[0])[:13]
    assert len(one_trace) == 13
    assert records(res["dp"]) == one_trace * 3


def test_train_lm_with_a_failure_matches_repro(monkeypatch, tmp_path,
                                               one_thread):  # noqa: F811
    cfg = dataclasses.replace(train_lm.CFG_100M, num_layers=2, d_model=64,
                              d_ff=256)
    jex = _jax_example("train_lm")
    jcfg = dataclasses.replace(jex.CFG_100M, num_layers=2, d_model=64,
                               d_ff=256)
    reports = []
    loop = jex.run_loop

    def jloop(*a, ckpt_dir, **k):
        reports.append(loop(*a, ckpt_dir=str(tmp_path / "jax"), **k)[1])
        return None, reports[-1]

    monkeypatch.setattr(jex, "CFG_100M", jcfg)
    monkeypatch.setattr(jex, "run_loop", jloop)
    monkeypatch.setattr(jex.shutil, "rmtree", lambda *a, **k: None)
    monkeypatch.setattr("sys.argv", ["train_lm", "--steps", "4",
                                     "--seq-len", "16", "--batch", "8",
                                     "--inject-failure"])
    jex.main()
    jrep = reports[0]

    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tm = tbuild(cfg, device="cpu")
    tp = from_jax_params(jax_params_np(jparams), cfg, device="cpu")
    rep = train_lm.run(tm, tp, steps=4, seq_len=16, batch=8,
                       injector=FaultInjector(fail_steps=(2,)),
                       ckpt_dir=str(tmp_path / "port"))["report"]
    assert (rep.failures, rep.restores, rep.steps_run) == \
        (jrep.failures, jrep.restores, jrep.steps_run) == (1, 0, 4)
    np.testing.assert_allclose([m["loss"] for m in rep.metrics],
                               [m["loss"] for m in jrep.metrics], rtol=1e-4)


_WALL = re.compile(r"ops_s|bytes_s")
_QUOTA = re.compile(r"^quota enforced: .*\((\d+) > 4096 bytes\)$")


def test_policy_demo_acts_match_repro(monkeypatch, capsys,
                                      one_thread):  # noqa: F811
    jex = _jax_example("policy_demo")
    sizes = []
    ones = jex.jnp.ones

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jex.jnp_real, name)

        def ones(self, shape, *a, **k):
            sizes.append(shape)
            return ones(shape, *a, **k)

    monkeypatch.setattr(jex, "jnp_real", jex.jnp, raising=False)
    monkeypatch.setattr(jex, "jnp", _Jnp())
    jex.main()
    want = capsys.readouterr().out.splitlines()
    out = policy_demo.run("cpu")
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if _WALL.search(w):
            continue
        if _QUOTA.match(w):
            assert _QUOTA.match(g)
            continue
        assert g == w
    # act 1: refused on the same payload, 512 x i elements
    big = [s[0] for s in sizes if isinstance(s, tuple) and s[0] % 512 == 0
           and s[0] >= 512]
    assert out["act1"]["quota_refused_at"] == big[-1] // 512 == 6
    # act 2: noisy throttled, victim never
    rep = out["act2"]["report"]
    assert rep["noisy"]["throttled"] > 0 == rep["victim"]["throttled"]
    # acts 3 and 4: the remesh after the trigger, grow-back, the budget
    kinds = [e["kind"] for e in out["act3"]["events"]]
    assert kinds == ["trigger", "remesh"]
    assert [m[0] for m in out["act4"]["moves"]] == ["shrink", "grow"]
    assert out["act4"]["slot_budget"] == 4
