"""Multi-pod dry run: trace every (architecture × input shape × mesh) cell
on the ``meta`` device and count its cost; the port's counterpart of
``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out runs/torch/dryrun]

``repro`` lowers and compiles each cell for a production mesh of 256 or
512 TPU chips (``make_production_mesh``: 16 × 16, or 2 × 16 × 16) and
reads ``memory_analysis()``, ``cost_analysis()`` and the collectives of
the compiled HLO.  PyTorch has no compiler to ask, so the port builds the
cell's model on ``meta`` at full width and depth, with parameters,
optimizer state, caches and batch as ``meta`` tensors (shapes, no data,
no memory), and runs one train step (the GSPMD ``make_train_step`` with
``fsdp=True``), one prefill or one decode step under
:class:`~repro_torch.analysis.cost.CostCounter`.  Nothing touches a card
or allocates a byte of data.

Each cell's JSON (``<out>/<arch>__<shape>__<single|multi>.json``) holds:

* ``repro``'s ``meta`` fields exactly: ``params``, ``active_params``,
  ``rules``; the train cell's ``microbatch``, ``param_dtype``,
  ``state_bytes_per_device`` and ``remat_stack_bytes_per_device``; the
  serve cells' ``params_bytes_per_device`` and
  ``cache_bytes_per_device``.  They are arithmetic over shapes and the
  partition specs of ``parallel/sharding.py`` (:func:`_sharded_bytes`);
* ``cost.flops_per_device`` and ``cost.bytes_per_device``: the logical
  program's totals (``cost.flops``, ``cost.bytes``: every rank's work)
  divided by the mesh's size, with the counter's breakdown
  (``matmul_flops``, the hand kernels' shape rules under ``kernels``);
* ``collectives`` and ``collective_bytes_total``: the dataplane's records
  of the traced call at the mesh's axis sizes
  (``analysis/cost.collectives``), and ``dataplane.logical_ops``;
* ``trace_s``, the seconds the traced call took.

More than one queued cell is traced in parallel, one process a cell, as
many at once as the host has cores (a ``meta`` op costs tens of
microseconds of host, and a full-size ``--all`` is over an hour of trace
in one process).

What is not there, and why:

* ``memory_analysis``: ``meta`` has no allocator.  The semantic bytes in
  its place are the ``*_bytes_per_device`` fields above, held against
  ``HBM_BUDGET_BYTES``, one H100's 80 GB (``fits``), not a TPU's HBM.
* ``lower_s`` / ``compile_s``: nothing is compiled; ``trace_s`` is the
  one time there is.
* ``--save-hlo``: there is no HLO to save.  The cell's JSON holds, in its
  place, the counter's per-kernel breakdown and the dataplane's records
  by kind.

The port runs a train step's microbatches as a Python loop, ``k`` times
(``dataplane.microbatches``), and records every executed edge, so its
``logical_ops`` and ``collectives`` are those of all ``k`` microbatches;
``repro`` records the edges of its microbatch scan once per trace.
A decode cell writes its token at the last position of a cache of the
shape's length (``pos = seq_len - 1``); ``repro`` traces ``pos`` as an
abstract scalar.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch.analysis.cost import CostCounter, collectives
from repro_torch.configs import SHAPES, cells, get_model_config
from repro_torch.configs.base import (DataplaneConfig, RunConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.dataplane import Dataplane
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.models import build_model
from repro_torch.models.api import input_specs
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.sharding import (_axis_size, activation_rules,
                                           cache_spec_tree, param_specs)
from repro_torch.train.step import TrainState, make_train_step

META = torch.device("meta")
HBM_BUDGET_BYTES = 80e9          # one H100's device memory


def _sharded_bytes(tree, spec_tree, sizes: dict) -> int:
    """Semantic per-device bytes of a tree of tensors under ``spec_tree``:
    each leaf's bytes over the ranks its spec shards it across, rounded
    down leaf by leaf, as ``repro``'s ``_sharded_bytes``."""
    total = 0
    for (_, leaf), (_, spec) in zip(tree_flatten(tree),
                                    tree_flatten(spec_tree)):
        ways = 1
        for ax in tuple(spec):
            ways *= _axis_size(ax, sizes)
        total += leaf.numel() * leaf.element_size() // max(ways, 1)
    return total


def _abstract_params(model, dtype: torch.dtype | None = None) -> dict:
    """The model's parameters on ``meta``: shapes and dtypes, no draw (a
    ``meta`` tensor holds no values, so the generator is never read).
    With ``dtype``, floating leaves take it."""
    params = model.init(torch.Generator())
    if dtype is None:
        return params
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


def _meta_batch(specs: dict) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in specs.items()}


def build_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
               remat: str = "full", seq_shard_prefill: bool = True):
    """Returns ``(fn, dp, meta, n_micro)``: ``fn()`` runs the cell's step
    on ``meta`` tensors; ``meta`` is ``repro``'s dict of the cell.
    (``repro``'s ``overrides`` argument has no caller and is not
    ported.)"""
    cfg = get_model_config(arch)
    model = build_model(cfg, device=META)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_axis_sizes(mesh)
    rules = activation_rules(cfg, shape, multi_pod=multi_pod,
                             seq_shard_prefill=seq_shard_prefill)
    dp = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh, rules=rules,
                   device=META)
    # every record of the traced call is kept: the collectives are summed
    # from them (a dataplane keeps only the newest KEEP_RECORDS)
    dp.telemetry.records = collections.deque()
    big = cfg.param_count() > 20e9
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "multi_pod": multi_pod, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "rules": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in rules.items()}}
    batch = _meta_batch(input_specs(cfg, shape))

    if shape.kind == "train":
        # gradient accumulation sized so the remat-saved activation stack
        # (L, B_local, S, D) stays under ~4.5 GB/device; bf16 master
        # weights for >100B archs (repro's sizing, unchanged)
        data_ways = sizes.get("data", 1) * sizes.get("pod", 1)
        s_total = shape.seq_len + (cfg.num_patches if cfg.family == "vlm"
                                   else 0)
        stack_per_seq = (cfg.num_layers + cfg.encoder_layers) * s_total \
            * cfg.d_model * 2
        mb_local = max(1, int(4.5e9 // max(stack_per_seq, 1)))
        mb_global = min(mb_local * data_ways, shape.global_batch)
        while shape.global_batch % mb_global:
            mb_global -= 1
        microbatch = 0 if mb_global >= shape.global_batch else mb_global
        huge = cfg.param_count() > 100e9
        opt_dtype = "bfloat16" if big else "float32"
        run = RunConfig(train=TrainConfig(remat=remat, microbatch=microbatch,
                                          opt_dtype=opt_dtype))
        meta["microbatch"] = microbatch
        meta["param_dtype"] = "bfloat16" if huge else "float32"
        params = _abstract_params(model, torch.bfloat16 if huge else None)
        state = TrainState(params=params, opt=adamw_init(params, opt_dtype),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=META))
        _, shard_fn = make_train_step(model, run, dp, fsdp=True)
        step = shard_fn(state, batch)
        pspec = param_specs(params, fsdp=True, mesh_sizes=sizes)
        meta["state_bytes_per_device"] = (
            _sharded_bytes(params, pspec, sizes)
            + 2 * _sharded_bytes(state.opt.mu, pspec, sizes))
        meta["remat_stack_bytes_per_device"] = int(
            stack_per_seq * max(mb_local, 1))
        n_micro = shape.global_batch // microbatch if microbatch else 1
        return (lambda: step(state, batch)), dp, meta, n_micro

    params = _abstract_params(model, torch.bfloat16)
    # serving: weights statically resident; dense archs shard over model
    # only, MoE archs get 2D expert sharding
    pspec = param_specs(params, fsdp=False, mesh_sizes=sizes,
                        serve_moe_2d=(cfg.family == "moe"))
    meta["params_bytes_per_device"] = _sharded_bytes(params, pspec, sizes)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    meta["cache_bytes_per_device"] = _sharded_bytes(
        cache, cache_spec_tree(cache, rules, sizes), sizes)
    if shape.kind == "prefill":
        return (lambda: model.prefill(params, batch, cache, dp=dp)), dp, \
            meta, 1
    return (lambda: model.decode_step(params, batch["token"], cache,
                                      shape.seq_len - 1, dp=dp)), dp, meta, 1


def _resident_bytes(meta: dict) -> int:
    if meta["kind"] == "train":
        return meta["state_bytes_per_device"] \
            + meta["remat_stack_bytes_per_device"]
    return meta["params_bytes_per_device"] + meta["cache_bytes_per_device"]


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             remat: str = "full", seq_shard_prefill: bool = True) -> dict:
    """Trace one cell under the cost counter; returns its result dict."""
    shape = SHAPES[shape_name]
    fn, dp, meta, n_micro = build_cell(arch, shape, multi_pod=multi_pod,
                                       remat=remat,
                                       seq_shard_prefill=seq_shard_prefill)
    n_dev = 1
    for n in dp.mesh.shape:
        n_dev *= n
    t0 = time.perf_counter()
    with CostCounter() as counter:
        fn()
    trace_s = time.perf_counter() - t0
    cost = counter.result()
    coll = collectives(dp.telemetry.records, mesh_axis_sizes(dp.mesh))
    resident = _resident_bytes(meta)
    result = {
        **meta,
        "ok": True,
        "trace_s": round(trace_s, 2),
        "cost": {"flops_per_device": cost["flops"] / n_dev,
                 "bytes_per_device": cost["bytes"] / n_dev,
                 "devices": n_dev, **cost},
        "collectives": coll,
        "collective_bytes_total": sum(v["bytes"] for v in coll.values()),
        "dataplane": {"mode": dp.mode,
                      "logical_ops": dp.telemetry.by_kind(),
                      "microbatches": n_micro},
        "hbm_budget_bytes": HBM_BUDGET_BYTES,
        "resident_bytes_per_device": resident,
        "fits": resident <= HBM_BUDGET_BYTES,
    }
    print(f"[{arch} × {shape_name} × "
          f"{'multi' if multi_pod else 'single'}-pod]")
    fits = "fits" if result["fits"] else "over"
    print(f"  resident/dev {resident / 2**30:.2f} GiB of "
          f"{HBM_BUDGET_BYTES / 1e9:.0f} GB ({fits})")
    print(f"  cost: flops/dev={result['cost']['flops_per_device']:.3e} "
          f"bytes/dev={result['cost']['bytes_per_device']:.3e} "
          f"trace {trace_s:.2f} s")
    mib = {k: (int(v["ops"]), round(v["bytes"] / 2**20, 1))
           for k, v in coll.items()}
    print(f"  collectives: {mib} (ops, MiB/dev)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--out", default="runs/torch/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = [(a, s.name) for a, s in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) else \
        [args.multi_pod]

    jobs = []
    for arch, shape_name in todo:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"skip {tag} (cached)")
                continue
            jobs.append((path, arch, shape_name, mp, args.remat,
                         not args.no_seq_shard))
    t0 = time.perf_counter()
    workers = min(len(os.sched_getaffinity(0)), len(jobs))
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            oks = list(pool.map(_write_cell, jobs))
    else:
        oks = [_write_cell(job) for job in jobs]
    failures = oks.count(False)
    print(f"{len(jobs)} cell(s) in {time.perf_counter() - t0:.1f} s, "
          f"{failures} failed")
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return 0


def _write_cell(job) -> bool:
    """Trace one cell and write its JSON (its failure, traceback and all,
    when it fails); True when it succeeded."""
    path, arch, shape_name, mp, remat, seq_shard = job
    try:
        res = run_cell(arch, shape_name, multi_pod=mp, remat=remat,
                       seq_shard_prefill=seq_shard)
    except Exception as e:  # noqa: BLE001 — record failures
        res = {"arch": arch, "shape": shape_name, "multi_pod": mp,
               "ok": False, "error": str(e),
               "traceback": traceback.format_exc()[-4000:]}
        print(f"FAILED {os.path.basename(path)[:-5]}: {e}", flush=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res["ok"]


if __name__ == "__main__":
    main()
