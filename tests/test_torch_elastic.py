"""Port parity for elastic scaling (``runtime/elastic.py``) and the train
launcher's ``--elastic`` loop.

``shrink_mesh`` gives ``repro``'s shapes and ``None`` cases on the port's
mesh descriptors; ``ElasticController`` over the same timeline records
``repro``'s events (kind, step, tenant, detail; the controller's own
events carry a wall stamp, which is not compared) and skip reasons, and
keeps every leaf of a live ``TrainState`` bit for bit.  The port's
launcher at ``--ranks 8 --elastic`` against ``repro``'s launcher on the
8-device CPU mesh, from the same parameters: the same events, and the
loss of every step within 1e-4 relative across the remesh (the mean
gradient does not depend on the rank count, up to summation order)."""

import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import ElasticConfig as JElastic
from repro.core import compat
from repro.core import obs as jobs
from repro.launch import train as jlaunch
from repro.models import build_model as jbuild
from repro.runtime import ElasticController as JController
from repro.runtime import shrink_mesh as jshrink
from repro.train import init_state as jinit

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.core import obs as tobs
from repro_torch.core.tree import tree_flatten
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import P
from repro_torch.runtime import ElasticController as TController
from repro_torch.runtime import elastic, remesh, shrink_mesh, state_shardings
from repro_torch.train import TrainState, init_state

from torch_port_util import jax_params_np

LOSS_RTOL = 1e-4


def _shape(m):
    return None if m is None else (tuple(m.devices.shape), m.axis_names)


def _tshape(m):
    return None if m is None else (tuple(m.shape), m.axis_names)


@pytest.mark.parametrize("which, factor, min_devices", [
    ("8", 2, 1), ("8", 4, 1), ("8", 8, 1), ("8", 16, 1), ("8", 1, 1),
    ("8", 2, 8), ("8", 2, 4), ("42", 2, 1), ("42", 2, 4), ("42", 2, 5),
    ("42", 4, 1), ("2", 2, 1), ("2", 2, 2), ("2", 4, 1)])
def test_shrink_mesh_matches(which, factor, min_devices, mesh8, mesh42,
                             mesh2):
    jmesh = {"8": mesh8, "42": mesh42, "2": mesh2}[which]
    tmesh = make_mesh(jmesh.devices.shape, jmesh.axis_names)
    j = jshrink(jmesh, factor, min_devices=min_devices)
    t = shrink_mesh(tmesh, factor, min_devices=min_devices)
    assert _tshape(t) == _shape(j)
    if j is not None:     # and twice, as a nested shrink would
        assert _tshape(shrink_mesh(t, factor)) == _shape(jshrink(j, factor))


@pytest.fixture(scope="module")
def tstate():
    cfg = tget("gemma3-1b", smoke=True)
    return init_state(tbuild(cfg, device="cpu"), 0)


@pytest.fixture(scope="module")
def jstate():
    return jinit(jbuild(jget("gemma3-1b", smoke=True)),
                 jax.random.PRNGKey(0))


def _events(timeline):
    return [(e["kind"], e["step"], e["tenant"], e["detail"])
            for e in timeline.events]


def _leaves(state):
    return [t.clone() for _, t in tree_flatten(
        {"p": state.params, "m": state.opt.mu, "n": state.opt.nu,
         "s": state.step})]


def _same(before, state) -> bool:
    return all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))


def _drive_pressure(mod, ctl, state, spans):
    """Snapshot ``spans`` of (first step, last step, denied share) into
    ``ctl.timeline`` and drive the controller after each span, as
    ``repro``'s tests do; returns the state and each drive's ``moved``."""
    moved = []
    for lo, hi, share in spans:
        for i in range(lo, hi + 1):
            ctl.timeline.snapshot(i, {"default": {
                "ops": 4.0 * i, "denied": 4.0 * i * share}}, t=float(i))
        state, m = ctl.drive(state, hi)
        moved.append(m)
    return state, moved


def test_controller_remeshes_live_train_state(mesh42, tstate, jstate):
    cfg = dict(enabled=True, thresholds=("denied_pct=50",), sustain=2,
               cooldown=4, shrink_factor=2, min_devices=2, max_remesh=1)
    jctl = JController(JElastic(**cfg), jobs.CounterTimeline(source="ctl"),
                       mesh42)
    tctl = TController(TElastic(**cfg), tobs.CounterTimeline(source="ctl"),
                       make_mesh((4, 2), ("data", "model")))
    spans = [(0, 0, 0.0), (1, 3, 1.0), (4, 11, 1.0)]
    _, jmoved = _drive_pressure(jobs, jctl, jstate, spans)
    before = _leaves(tstate)
    state, tmoved = _drive_pressure(tobs, tctl, tstate, spans)
    assert tmoved == jmoved == [False, True, False]
    assert _events(tctl.timeline) == _events(jctl.timeline)
    assert [e[0] for e in _events(tctl.timeline)] == \
        ["trigger", "remesh", "trigger", "remesh-skipped"]
    assert tctl.mesh.shape == (2, 2) and tctl.remeshes == 1
    assert _same(before, state)


def test_controller_shrink_grow_cycle(mesh42, tstate, jstate):
    cfg = dict(enabled=True, thresholds=("denied_pct=50",),
               release_thresholds=("denied_pct=5",), sustain=2, cooldown=1,
               release_sustain=2, release_cooldown=0, shrink_factor=2,
               min_devices=2, max_remesh=1)
    out = {}
    for name, mod, ctl_cls, ecfg, mesh, state in (
            ("repro", jobs, JController, JElastic, mesh42, jstate),
            ("port", tobs, TController, TElastic,
             make_mesh((4, 2), ("data", "model")), tstate)):
        ctl = ctl_cls(ecfg(**cfg), mod.CounterTimeline(source="cycle"), mesh)
        before = _leaves(tstate)
        ops = den = 0.0
        ctl.timeline.snapshot(0, {"default": {"ops": 0, "denied": 0}},
                              t=0.0)
        moved, shapes = [], []
        for i, pct in enumerate([80, 80, 0, 0, 0, 80, 80], start=1):
            ops, den = ops + 4.0, den + 4.0 * pct / 100.0
            ctl.timeline.snapshot(i, {"default": {"ops": ops,
                                                  "denied": den}},
                                  t=float(i))
            if name == "repro":
                _, m = ctl.drive(state, i)
                shapes.append(tuple(ctl.mesh.devices.shape))
            else:
                state, m = ctl.drive(state, i)
                shapes.append(ctl.mesh.shape)
            moved.append(m)
        out[name] = (moved, shapes, ctl.remeshes, ctl.grows,
                     _events(ctl.timeline))
        if name == "port":
            assert _same(before, state)
    assert out["port"] == out["repro"]
    kinds = [(e[0], e[3].get("direction")) for e in out["port"][4]]
    assert kinds[:4] == [("trigger", None), ("remesh", "shrink"),
                         ("recover", None), ("remesh", "grow")]
    assert kinds[-1] == ("remesh-skipped", None)


def test_skip_reasons_equal(mesh42):
    """No smaller mesh, and a grow with no shrink on record: the same
    recorded reasons, word for word (the mesh shape printed as a tuple)."""
    devs = jax.devices()
    cfg = dict(enabled=True, thresholds=("denied_pct=50",), sustain=1,
               cooldown=0, min_devices=1)
    got = []
    for mod, ctl_cls, ecfg, mesh in (
            (jobs, JController, JElastic,
             compat.make_mesh((1,), ("data",), devices=devs[:1])),
            (tobs, TController, TElastic, make_mesh((1,), ("data",)))):
        ctl = ctl_cls(ecfg(**cfg), mod.CounterTimeline(source="tiny"), mesh)
        ctl.timeline.snapshot(0, {"default": {"ops": 0, "denied": 0}}, t=0.0)
        ctl.timeline.snapshot(1, {"default": {"ops": 4, "denied": 4}}, t=1.0)
        state = object()
        out, moved = ctl.drive(state, 1)
        assert out is state and not moved
        g_out, g_moved = ctl.grow_mesh(state, 5)
        assert g_out is state and not g_moved and ctl.grows == 0
        got.append(_events(ctl.timeline))
    assert got[0] == got[1]
    reasons = [e[3]["reason"] for e in got[1] if e[0] == "remesh-skipped"]
    assert reasons[0] == ("no smaller mesh: shape (1,) cannot shrink by 2 "
                          "above min_devices=1")
    assert reasons[1].startswith("nothing to grow back to")


def test_remesh_checks_specs_and_keeps_every_leaf(tstate, monkeypatch):
    state = tstate._replace(err={"embed": {"tok": torch.zeros(())}})
    mesh = make_mesh((4, 2), ("data", "model"))
    before = _leaves(state)
    specs = state_shardings(state, mesh, fsdp=True)
    assert set(specs.params) == set(state.params)
    out = remesh(state, mesh, fsdp=True)
    assert _same(before, out) and out.params is state.params
    # a spec the shapes cannot take is refused, as jit's shardings are
    real = elastic.param_specs
    monkeypatch.setattr(elastic, "param_specs", lambda p, **kw: {
        **real(p, **kw), "odd": P("data", None)})
    bad = tstate._replace(params={**tstate.params, "odd": torch.zeros(3, 5)})
    with pytest.raises(ValueError, match="odd"):
        remesh(bad, mesh)


ELASTIC_ARGS = ["steps=6", "seq_len=16", "global_batch=8", "log_every=1",
                "elastic.meter_quota_bytes=1000",
                "elastic.thresholds=denied_pct=50", "elastic.sustain=2",
                "elastic.cooldown=1", "elastic.min_devices=2"]


def test_launcher_elastic_matches_jax(tmp_path, monkeypatch):
    """Both launchers from the same parameters: a remesh 8 → 4 ranks at
    step 3, a second trigger skipped for the remesh budget, the same
    events, and every step's loss within 1e-4 relative."""
    reports = {}
    real_loop = jlaunch.run_loop

    def keep_report(*a, **kw):
        state, rep = real_loop(*a, **kw)
        reports["repro"] = rep
        return state, rep

    monkeypatch.chdir(tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(jlaunch, "run_loop", keep_report)
    monkeypatch.setattr(sys, "argv", ["train", "--elastic", *ELASTIC_ARGS])
    jlaunch.main()
    jdoc = jobs.CounterTimeline.load("runs/gemma3-1b_timeline.json")

    jcfg, tcfg = jget("gemma3-1b", smoke=True), tget("gemma3-1b", smoke=True)

    def same_params(model, seed, compression="none", opt_dtype="float32"):
        jstate = jinit(jbuild(jcfg), jax.random.PRNGKey(seed))
        tp = from_jax_params(jax_params_np(jstate.params), tcfg, "cpu")
        return TrainState(params=tp, opt=adamw_init(tp, opt_dtype),
                          step=torch.zeros((), dtype=torch.int32))

    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(tlaunch, "init_state", same_params)
    _, rep = tlaunch.main(["--device", "cpu", "--ranks", "8", "--elastic",
                           *ELASTIC_ARGS])
    tdoc = tobs.CounterTimeline.load("runs/torch/gemma3-1b_timeline.json")

    def events(doc):
        return [(e["kind"], e["step"], e["tenant"], e["detail"])
                for e in doc["events"]]

    assert events(tdoc) == events(jdoc)
    assert [e[0] for e in events(tdoc)] == \
        ["trigger", "remesh", "trigger", "remesh-skipped"]
    assert tdoc["events"][1]["detail"]["devices_after"] == 4
    assert [s["step"] for s in tdoc["samples"]] == list(range(1, 7))
    jobs.validate_timeline(tdoc)
    np.testing.assert_allclose([m["loss"] for m in rep.metrics],
                               [m["loss"] for m in reports["repro"].metrics],
                               rtol=LOSS_RTOL)


@pytest.mark.cuda
def test_card_launcher_timeline_is_bit_identical(tmp_path, monkeypatch):
    """On the card: 3 launcher steps with ``--timeline`` and 3 without, at
    2 ranks, end in the same params and moments bit for bit."""
    from torch_port_util import cuda_device

    cuda_device()
    monkeypatch.chdir(tmp_path)
    argv = ["--ranks", "2", "steps=3", "seq_len=32", "global_batch=2"]
    on, rep_on = tlaunch.main(["--timeline", *argv])
    off, rep_off = tlaunch.main(argv)
    assert [m["loss"] for m in rep_on.metrics] == \
        [m["loss"] for m in rep_off.metrics]
    assert _same(_leaves(off), on)
    doc = tobs.CounterTimeline.load("runs/torch/gemma3-1b_timeline.json")
    assert [s["step"] for s in doc["samples"]] == [1, 2, 3]
