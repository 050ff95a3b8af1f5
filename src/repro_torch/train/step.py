"""Train-step builders: the GSPMD step and the explicit data-parallel
step, the measured CoRD path.

:func:`make_train_step` is ``repro``'s pjit/GSPMD step: every
communication edge inside the model, the loss included, crosses the
dataplane as a constraint (``model.loss(..., dp=dp)``), and with a mesh
and cost emulation each launches the dataplane kernel, whose autograd
function passes the gradient across unchanged.  ``repro`` jits it with
in/out shardings from ``parallel/sharding.py``; on one card the specs are
derived and checked against the shapes, and placement is the identity.

``repro``'s ``make_explicit_dp_step`` runs under ``shard_map`` over the
data axis: each device computes its shard's gradients, the gradient
all-reduce is issued explicitly through the dataplane (bucketing, QoS,
int8 compression), and AdamW runs on the mean.  Here the R ranks of the
mesh axis share one card (``launch/mesh.py``): each rank's contiguous
block of the global batch is run forward and backward in turn, its
gradients land in slice ``r`` of rank-stacked (R, ...) buffers, and
``sync_grads`` all-reduces those through the dataplane's explicit
``psum``.  The loss and metrics are the mean over ranks (``pmean``), and
AdamW runs once on the mean gradients, which every rank holds equal.
The microbatches of ``_accumulate`` are a Python loop in ``repro``'s
order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.obs import span
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.optim.adamw import adamw_init, adamw_update, warmup_cosine
from repro_torch.parallel.sharding import P, batch_specs, param_specs
from repro_torch.train.gradsync import err_state_init, sync_grads


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor
    err: Any = None      # compression error feedback


def init_state(model, seed, compression: str = "none",
               opt_dtype: str = "float32") -> TrainState:
    """Fresh parameters from ``seed`` (an int or a ``torch.Generator``),
    zero moments and step."""
    return state_from_params(model.init(seed), compression, opt_dtype)


def state_from_params(params: dict, compression: str = "none",
                      opt_dtype: str = "float32") -> TrainState:
    """The train state :func:`init_state` builds around ``params`` (held,
    not copied: a step updates them in place)."""
    dev = tree_flatten(params)[0][1].device
    return TrainState(params=params, opt=adamw_init(params, opt_dtype),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      err=err_state_init(params, compression))


def _value_and_grad(loss_fn, params: dict, batch: dict):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``; grads
    in ``params``' nesting, metrics detached."""
    flat = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(
            tree_unflatten([path for path, _ in flat], leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = tree_map(lambda m: m.detach() if isinstance(m, torch.Tensor)
                       else m, metrics)
    return (loss.detach(), metrics), tree_unflatten(
        [path for path, _ in flat], grads)


def _accumulate(loss_fn, params, batch, microbatch: int):
    """Gradient accumulation over microbatches, in ``repro``'s order: the
    first microbatch's values, plus each later one's, times 1/n."""
    b = tree_flatten(batch)[0][1].shape[0]
    if microbatch <= 0 or microbatch >= b:
        return _value_and_grad(loss_fn, params, batch)
    if b % microbatch:
        raise ValueError(f"batch {b} is no multiple of microbatch "
                         f"{microbatch}")
    n = b // microbatch
    micro = [tree_map(lambda x: x[i * microbatch:(i + 1) * microbatch],
                      batch) for i in range(n)]
    (loss, metrics), grads = _value_and_grad(loss_fn, params, micro[0])
    for mb in micro[1:]:
        (l_i, m_i), g_i = _value_and_grad(loss_fn, params, mb)
        loss = loss + l_i
        metrics = tree_map(lambda a, c: a + c, metrics, m_i)
        grads = tree_map(lambda a, c: a + c, grads, g_i)
    inv = 1.0 / n
    return (loss * inv, tree_map(lambda m: m * inv, metrics)), \
        tree_map(lambda g: g * inv, grads)


def rank_grads(model, params: dict, batch: dict, n_ranks: int, *,
               microbatch: int = 0, remat: str = "none",
               impl: str = "flash"):
    """Every rank's loss, metrics and gradients over its contiguous block
    of ``batch``: ``(losses, metrics list, rank-stacked grads)``.  Each
    rank's gradients are copied into slice ``r`` of (R, ...) buffers as
    soon as its backward ends, so at most one rank's are held apart."""
    b = tree_flatten(batch)[0][1].shape[0]
    if b % n_ranks:
        raise ValueError(f"global batch {b} does not split over {n_ranks} "
                         f"ranks")
    per = b // n_ranks

    def loss_fn(p, mb):
        return model.loss(p, mb, dp=None, remat=remat, impl=impl)

    losses, metrics, stacked = [], [], None
    for r in range(n_ranks):
        with span("train.rank_grads", rank=r):
            shard = tree_map(lambda x: x[r * per:(r + 1) * per], batch)
            (loss, m), grads = _accumulate(loss_fn, params, shard,
                                           microbatch)
            if stacked is None:
                stacked = tree_map(lambda g: torch.empty(
                    (n_ranks,) + tuple(g.shape), dtype=g.dtype,
                    device=g.device), grads)
            tree_map(lambda buf, g: buf[r].copy_(g), stacked, grads)
            del grads
        losses.append(loss)
        metrics.append(m)
    return losses, metrics, stacked


def _pmean(values: list) -> torch.Tensor:
    total = values[0].to(torch.float32)
    for v in values[1:]:
        total = total + v.to(torch.float32)
    return total / len(values)


# ---------------------------------------------------------------------------
# the GSPMD step
# ---------------------------------------------------------------------------

def _check_specs(specs, tree, sizes: dict, what: str) -> None:
    """Each spec fits its leaf: no more entries than dims, known mesh
    axes, and every sharded dim a multiple of its axes' ranks (what jit's
    in/out shardings require)."""
    for (path, spec), (_, leaf) in zip(tree_flatten(specs),
                                       tree_flatten(tree)):
        if len(spec) > leaf.ndim:
            raise ValueError(f"{what} {'/'.join(path)}: spec {spec} has "
                             f"more entries than dims {tuple(leaf.shape)}")
        for dim, entry in enumerate(spec):
            axes = () if entry is None else (
                tuple(entry) if isinstance(entry, (tuple, list)) else
                (entry,))
            n = 1
            for a in axes:
                if a not in sizes:
                    raise ValueError(f"{what} {'/'.join(path)}: no mesh axis "
                                     f"{a!r} in {tuple(sizes)}")
                n *= sizes[a]
            if leaf.shape[dim] % n:
                raise ValueError(f"{what} {'/'.join(path)}: dim {dim} of "
                                 f"{tuple(leaf.shape)} does not split over "
                                 f"{axes} ({n} ranks)")


def make_train_step(model, run, dp, *, total_steps: int | None = None,
                    fsdp: bool = False, jit: bool = True):
    """The GSPMD step: ``step(state, batch) -> (state, metrics)``, the
    loss ``model.loss(params, batch, dp=dp, remat=run.train.remat)``
    through ``_accumulate`` and AdamW.

    As ``repro``'s: with ``jit=False`` or a dataplane with no mesh it
    returns the step alone; otherwise ``(step, shard_fn)``, where
    ``shard_fn(state_like, batch_like)`` derives the state specs
    (``param_specs`` with ``fsdp``) and the batch specs (``batch_specs``
    with ``dp.rules``), checks them against the shapes, and returns the
    step with the specs as its ``in_specs``."""
    tcfg = run.train
    schedule = warmup_cosine(tcfg, total_steps)

    def loss_fn(params, batch):
        return model.loss(params, batch, dp=dp, remat=tcfg.remat)

    def step_fn(state: TrainState, batch):
        (loss, metrics), grads = _accumulate(loss_fn, state.params, batch,
                                             tcfg.microbatch)
        with span("train.adamw", device=state.step.device):
            new_params, new_opt, stats = adamw_update(
                grads, state.opt, state.params, tcfg, schedule)
        metrics = {**metrics, **stats}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, err=state.err), metrics

    if not jit or dp.mesh is None:
        return step_fn
    sizes = mesh_axis_sizes(dp.mesh)

    def shard_fn(state_like: TrainState, batch_like):
        pspec = param_specs(state_like.params, fsdp=fsdp, mesh_sizes=sizes)
        _check_specs(pspec, state_like.params, sizes, "parameter")
        err = None if state_like.err is None else param_specs(
            state_like.err, fsdp=fsdp, mesh_sizes=sizes)
        st_spec = TrainState(
            params=pspec,
            opt=type(state_like.opt)(step=P(), mu=pspec, nu=pspec),
            step=P(), err=err)
        b_spec = batch_specs(batch_like, dp.rules)
        _check_specs(b_spec, batch_like, sizes, "batch")

        def step(state: TrainState, batch):
            return step_fn(state, batch)

        step.in_specs = (st_spec, b_spec)
        return step

    return step_fn, shard_fn


# ---------------------------------------------------------------------------
# the explicit data-parallel step
# ---------------------------------------------------------------------------

def make_explicit_dp_step(model, run, dp, *, axis: str = "data",
                          total_steps: int | None = None,
                          runtime_accounting: bool = False):
    """DP over mesh axis ``axis`` of ``dp``: per-rank gradients and the
    dataplane all-reduce.  ``step(state, batch) -> (state, metrics)``;
    with ``runtime_accounting=True`` the dataplane's runtime state
    (``dp.runtime_init()``) is threaded through the gradient sync:
    ``step(state, batch, rt) -> (state, metrics, rt)``.  ``batch`` is the
    global batch; rank ``r`` takes its ``r``-th contiguous block."""
    tcfg = run.train
    schedule = warmup_cosine(tcfg, total_steps)
    n = dp.axis_size(axis)

    def local_step(state: TrainState, batch, rt):
        losses, rank_metrics, grads = rank_grads(
            model, state.params, batch, n, microbatch=tcfg.microbatch,
            remat=tcfg.remat)
        err = None if state.err is None else tree_map(
            lambda e: e.unsqueeze(0).expand((n,) + tuple(e.shape)),
            state.err)
        grads, new_err, rt = sync_grads(
            dp, grads, axis, compression=tcfg.grad_compression,
            err_state=err, state=rt)
        metrics = tree_map(lambda *ms: _pmean(list(ms)), *rank_metrics)
        mean = tree_map(lambda g: g[0], grads)
        with span("train.adamw", device=state.step.device):
            new_params, new_opt, stats = adamw_update(
                mean, state.opt, state.params, tcfg, schedule)
        metrics = {**metrics, **stats}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1,
                          err=tree_map(lambda e: e[0], new_err)), \
            metrics, rt

    if runtime_accounting:
        return local_step

    def stateless_step(state: TrainState, batch):
        new_state, metrics, _ = local_step(state, batch, None)
        return new_state, metrics

    return stateless_step


__all__ = ["TrainState", "init_state", "state_from_params",
           "make_train_step", "make_explicit_dp_step", "rank_grads"]
