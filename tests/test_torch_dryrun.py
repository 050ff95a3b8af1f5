"""The port's dry run (``repro_torch.launch.dryrun``) and cost counter
(``repro_torch.analysis.cost``) against ``repro``.

``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` when it is imported, so
this file never imports it: ``repro``'s ``meta`` fields are recomputed
here from ``repro.configs``, ``repro.parallel.sharding`` and the shapes
``jax.eval_shape`` gives, by ``repro``'s formulas.

Tolerances:
* ``meta``: exact, for every cell of ``cells()`` on both production
  meshes (16 x 16 and 2 x 16 x 16);
* FLOPs: exact, after two stated corrections.  The counter's FLOPs of a
  smoke prefill and of a ``remat="none"`` train step on an (8, 1)
  ``("data", "model")`` mesh are held against
  ``repro.analysis.hlo.analyze`` of the same cell compiled on the
  harness's 8 CPU devices, summed over them.  (a) ``repro``'s XLA
  attention computes every (query, key) block in full, while the flash
  kernel's shape rule is priced by the pairs its masks leave; the port's
  forward attention is therefore taken in full here, 4·B·H·S²·D a layer
  (two products), and in the train step its backward too, 10·B·H·S²·D a
  layer (five products), which XLA computes block by block in full and
  the flash backward kernel's shape rule prices by the pairs.
  (b) GSPMD computes the prefill's last-token logits on every device of
  the data axis (its batch is replicated there, its sequence sharded),
  so the summed HLO holds them 8 times; and the port's chunked
  cross-entropy computes each chunk's logits again in its backward, so
  it holds one more logits product than XLA's.  Nothing else differs:
  every matrix product is counted with the same formula."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo import analyze
from repro.configs import cells as jcells
from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.core import compat
from repro.core.dataplane import Dataplane as JDataplane
from repro.models import build_model as jbuild
from repro.parallel import sharding as jsh
from repro.train.step import init_state as jinit
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.analysis.cost import CostCounter, attention_pairs
from repro_torch.configs import SHAPES
from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig, RunConfig, TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.dataplane import Dataplane
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel.sharding import activation_rules
from repro_torch.train import make_train_step, state_from_params

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def _sharded_bytes(tree, specs, sizes) -> int:
    """``repro``'s per-device bytes: each leaf over its spec's ranks."""
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        ways = 1
        for ax in tuple(spec):
            ways *= jsh._axis_size(ax, sizes)
        total += int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize \
            // max(ways, 1)
    return total


def _as(tree, dtype):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        x.shape, dtype if jnp.issubdtype(x.dtype, jnp.floating)
        else x.dtype), tree)


def _repro_meta(arch, shape, multi_pod, model, params) -> dict:
    cfg = model.cfg
    sizes = MESHES[multi_pod]
    rules = jsh.activation_rules(cfg, shape, multi_pod=multi_pod)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "multi_pod": multi_pod, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "rules": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in rules.items()}}
    big = cfg.param_count() > 20e9
    if shape.kind == "train":
        data_ways = sizes.get("data", 1) * sizes.get("pod", 1)
        s_total = shape.seq_len + (cfg.num_patches if cfg.family == "vlm"
                                   else 0)
        stack = (cfg.num_layers + cfg.encoder_layers) * s_total \
            * cfg.d_model * 2
        mb_local = max(1, int(4.5e9 // max(stack, 1)))
        mb_global = min(mb_local * data_ways, shape.global_batch)
        while shape.global_batch % mb_global:
            mb_global -= 1
        huge = cfg.param_count() > 100e9
        meta["microbatch"] = 0 if mb_global >= shape.global_batch \
            else mb_global
        meta["param_dtype"] = "bfloat16" if huge else "float32"
        p = _as(params, jnp.bfloat16) if huge else params
        mu = _as(params, jnp.bfloat16 if big else jnp.float32)
        pspec = jsh.param_specs(p, fsdp=True, mesh_sizes=sizes)
        meta["state_bytes_per_device"] = (
            _sharded_bytes(p, pspec, sizes)
            + 2 * _sharded_bytes(mu, pspec, sizes))
        meta["remat_stack_bytes_per_device"] = int(stack * max(mb_local, 1))
        return meta
    p = _as(params, jnp.bfloat16)
    pspec = jsh.param_specs(p, fsdp=False, mesh_sizes=sizes,
                            serve_moe_2d=(cfg.family == "moe"))
    meta["params_bytes_per_device"] = _sharded_bytes(p, pspec, sizes)
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    meta["cache_bytes_per_device"] = _sharded_bytes(
        cache, jsh.cache_spec_tree(cache, rules, sizes), sizes)
    return meta


def test_meta_equals_repro_for_every_cell():
    by_arch: dict = {}
    for arch, shape in jcells():
        if arch not in by_arch:
            model = jbuild(jget(arch))
            by_arch[arch] = (model, jax.eval_shape(
                lambda m=model: m.init(jax.random.PRNGKey(0))))
        model, params = by_arch[arch]
        for multi_pod in (False, True):
            _, _, meta, _ = dryrun.build_cell(arch, SHAPES[shape.name],
                                              multi_pod=multi_pod)
            assert meta == _repro_meta(arch, shape, multi_pod, model,
                                       params), (arch, shape.name, multi_pod)


def test_dry_run_writes_a_cell_and_touches_no_device(tmp_path, monkeypatch):
    """``main`` on one small cell (whisper-small decode): a JSON with
    the counter's cost and the dataplane's records; every tensor of the
    traced call lies on ``meta``."""
    monkeypatch.setattr(dryrun, "get_model_config",
                        lambda a: tget(a, smoke=True))
    devices = set()

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in jax.tree.leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    devices.add(t.device.type)
            return out

    with Watch():
        dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert devices == {"meta"}
    with open(tmp_path / "whisper-small__decode_32k__single.json") as f:
        res = json.load(f)
    assert res["ok"] and res["cost"]["devices"] == 256
    assert res["cost"]["flops_per_device"] == res["cost"]["flops"] / 256 > 0
    assert res["collectives"]["constraint"]["ops"] == \
        res["dataplane"]["logical_ops"]["constraint"]["ops"] > 0
    assert res["fits"] and "memory" not in res


@pytest.mark.parametrize("causal,window,valid", [(True, 0, None),
                                                 (True, 5, None),
                                                 (False, 0, 40),
                                                 (True, 3, 7)])
def test_attention_pairs_count_the_mask(causal, window, valid):
    sq, skv = 33, 50
    q = np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    mask = np.broadcast_to(k < (skv if valid is None else valid),
                           (sq, skv)).copy()
    if causal:
        mask &= k <= q
    if window:
        mask &= q - k < window
    assert attention_pairs(sq, skv, causal, window, valid) == int(mask.sum())


B, S = 8, 64


def _cells(kind):
    jcfg, tcfg = jget("gemma3-1b", smoke=True), tget("gemma3-1b", smoke=True)
    mesh = compat.make_mesh((8, 1), ("data", "model"))
    jdp = JDataplane(JCfg(mode="cord"), mesh=mesh, rules=jsh.activation_rules(
        jcfg, JShape("cell", S, B, kind)))
    tdp = Dataplane(DataplaneConfig(mode="cord"),
                    mesh=make_mesh((8, 1), ("data", "model")),
                    rules=activation_rules(tcfg, ShapeConfig("cell", S, B,
                                                             kind)),
                    device="meta")
    tm = build_model(tcfg, device="meta")
    return jcfg, jbuild(jcfg), jdp, tcfg, tm, tdp


def _attention_in_full(tcfg, products: int = 2) -> int:
    """FLOPs of ``products`` attention products a layer, every (query,
    key) pair counted: 2 per pair, head and head dimension each."""
    a = tcfg.attention
    return (tcfg.num_layers * 2 * products * B * a.num_heads * S * S
            * a.head_dim)


def test_prefill_flops_match_the_hlo():
    jcfg, jm, jdp, tcfg, tm, tdp = _cells("prefill")
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jc = jax.eval_shape(lambda: jm.init_cache(B, S))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    hlo = jax.jit(lambda p, b, c: jm.prefill(p, b, c, dp=jdp)).lower(
        jp, {"tokens": tokens}, jc).compile().as_text()
    want = analyze(hlo)["flops"] * 8
    with CostCounter() as c:
        tm.prefill(tm.init(torch.Generator()),
                   {"tokens": torch.empty((B, S), dtype=torch.int32,
                                          device="meta")},
                   tm.init_cache(B, S), dp=tdp)
    assert c.kernels["flash_attention"]["calls"] == tcfg.num_layers
    logits = 2 * B * tcfg.d_model * tcfg.vocab_size   # last token, B rows
    assert c.matmul_flops + _attention_in_full(tcfg) + 7 * logits == want


def test_train_step_flops_match_the_hlo():
    jcfg, jm, jdp, tcfg, tm, tdp = _cells("train")
    jrun, trun = (JRun(train=JTrain(remat="none")),
                  RunConfig(train=TrainConfig(remat="none")))
    st = jax.eval_shape(lambda: jinit(jm, jax.random.PRNGKey(0)))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    _, shard = jmake_train_step(jm, jrun, jdp, fsdp=True)
    want = analyze(shard(st, batch).lower(st, batch).compile().as_text())[
        "flops"] * 8
    _, tshard = make_train_step(tm, trun, tdp, fsdp=True)
    ts = state_from_params(tm.init(torch.Generator()))
    tb = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    with CostCounter() as c:
        tshard(ts, tb)(ts, tb)
    assert c.kernels["flash_attention_bwd"]["calls"] == tcfg.num_layers
    logits = 2 * B * S * tcfg.d_model * tcfg.vocab_size
    assert c.matmul_flops + _attention_in_full(tcfg) + _attention_in_full(
        tcfg, products=5) - logits == want
