"""Port parity: every config dataclass of repro_torch equals repro's.

Tolerance: exact (configs are pure data)."""

import dataclasses

import pytest

from repro import configs as jcfg
from repro.configs import base as jbase

from repro_torch import configs as tcfg
from repro_torch.configs import base as tbase


def _as_tree(obj):
    """Dataclass -> (class name, {field: value}) recursively."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _as_tree(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    return obj


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_model_config_equal(arch, smoke):
    j = jcfg.get_model_config(arch, smoke=smoke)
    t = tcfg.get_model_config(arch, smoke=smoke)
    assert _as_tree(t) == _as_tree(j)
    assert t.head_dim == j.head_dim
    assert t.param_count() == j.param_count()
    assert t.is_subquadratic == j.is_subquadratic


def test_registry_and_run_configs_equal():
    assert tcfg.ARCHS == jcfg.ARCHS
    assert tcfg.LONG_CONTEXT_ARCHS == jcfg.LONG_CONTEXT_ARCHS
    for skipped in (False, True):
        assert [(a, _as_tree(s)) for a, s in tcfg.cells(skipped)] == \
            [(a, _as_tree(s)) for a, s in jcfg.cells(skipped)]
    assert {k: _as_tree(v) for k, v in tbase.SHAPES.items()} == \
        {k: _as_tree(v) for k, v in jbase.SHAPES.items()}
    assert _as_tree(tbase.RunConfig()) == _as_tree(jbase.RunConfig())


def test_apply_overrides_equal():
    ovs = ["train.steps=7", "dataplane.mode=socket",
           "dataplane.policies=telemetry,quota", "model.d_model=96",
           "serve.block_size=16", "dataplane.emulate_costs=true"]
    assert _as_tree(tbase.apply_overrides(tbase.RunConfig(), ovs)) == \
        _as_tree(jbase.apply_overrides(jbase.RunConfig(), ovs))
    with pytest.raises(KeyError):
        tbase.apply_overrides(tbase.RunConfig(), ["train.nope=1"])
