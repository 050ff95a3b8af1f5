"""Port parity for the sharding rules (``repro_torch.parallel``) against
``repro.parallel.sharding``: for all 10 presets at full size (shapes from
``jax.eval_shape``, nothing allocated), on the production meshes (16, 16)
and (2, 16, 16), every shape cell: ``activation_rules``, ``param_specs``
with FSDP off and on, ``batch_specs`` and ``cache_spec_tree``.

Tolerance: exact (the same spec, entry for entry, for every leaf)."""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_model_config as jget
from repro.models import build_model as jbuild
from repro.parallel import sharding as js

from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_model_config as tget
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.parallel import sharding as ts


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, JP))]


def _tspecs(tree):
    return [tuple(s) for s in tree_leaves(tree)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, multi_pod):
    jcfg, tcfg = jget(arch), tget(arch)
    model = jbuild(jcfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_axis_sizes(mesh)
    assert sizes == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                     else {"data": 16, "model": 16})
    for fsdp in (False, True):
        want = _jspecs(js.param_specs(params, fsdp=fsdp, mesh_sizes=sizes))
        got = ts.param_specs(params, fsdp=fsdp, mesh_sizes=sizes)
        assert _tspecs(got) == want, fsdp
        assert all(isinstance(s, ts.PartitionSpec) for s in tree_leaves(got))
    for name, shape in JSHAPES.items():
        rules = js.activation_rules(jcfg, shape, multi_pod=multi_pod)
        assert ts.activation_rules(tcfg, TSHAPES[name],
                                   multi_pod=multi_pod) == rules, name
        b, s = shape.global_batch, shape.seq_len
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), "int32"),
                 "labels": jax.ShapeDtypeStruct((b, s), "int32"),
                 "weight": jax.ShapeDtypeStruct((), "float32")}
        for msz in (None, sizes):
            assert _tspecs(ts.batch_specs(batch, rules, msz)) == \
                _jspecs(js.batch_specs(batch, rules, msz)), name
        if shape.kind != "train":
            cache = jax.eval_shape(lambda: model.init_cache(b, s))
            assert _tspecs(ts.cache_spec_tree(cache, rules, sizes)) == \
                _jspecs(js.cache_spec_tree(cache, rules, sizes)), name


def test_partition_spec_and_filter():
    spec = ts.P("data", None, ("pod", "model"))
    assert spec == ("data", None, ("pod", "model")) and len(spec) == 3
    assert repr(spec) == "P('data', None, ('pod', 'model'))"
    sizes = {"data": 16, "model": 16, "pod": 2}
    assert tuple(ts.filter_spec(spec, (32, 3, 7, 5), sizes)) == \
        tuple(js.filter_spec(JP("data", None, ("pod", "model")),
                             (32, 3, 7, 5), sizes))
