"""Faults planted under the timed path, for the readings that set the
limits' upper ends (`calibrate.py`) and for the tests that see `correct`
come out false.  Each is a context manager that swaps one function the
port's entry looks up at call time, and puts it back after; the benchmark's
own runs never use them.

- ``frozen_state``: the train step returns its state unchanged;
- ``half_batch``: each step sees only the first half of its rows, the
  mean taken over them;
- ``no_exchange``: the gradient sync is left out, so the update takes rank
  0's gradient alone;
- ``altered_token``: every third sampling call returns each slot's token
  plus one.
"""

from __future__ import annotations

import contextlib

import torch

TRAIN_FAULTS = ("frozen_state", "half_batch", "no_exchange")
SERVE_FAULTS = ("altered_token",)


@contextlib.contextmanager
def _swap(module, name: str, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _frozen(real):
    def update(grads, state, params, cfg, schedule=None):
        gn = torch.sqrt(sum(g.float().square().sum()
                            for g in _leaves(grads)))
        return params, state, {"lr": torch.zeros_like(gn), "grad_norm": gn}
    return update


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves
    return tree_leaves(tree)


def _half(real):
    def rank_grads(model, params, batch, n_ranks, **kw):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(model, params, half, n_ranks, **kw)
    return rank_grads


def _no_exchange(real):
    def sync_grads(dp, grads, axis, *, compression="none", err_state=None,
                   state=None, **kw):
        from repro_torch.core.tree import tree_map
        n = dp.axis_size(axis)
        err = tree_map(lambda g: torch.zeros((n,), dtype=torch.float32,
                                             device=g.device), grads)
        return grads, err, state
    return sync_grads


def _altered(real):
    calls = [0]

    def sample(logits, gen, temperature):
        tok = real(logits, gen, temperature)
        calls[0] += 1
        if calls[0] % 3 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    return sample


@contextlib.contextmanager
def planted(name: str | None):
    """Run the body with fault ``name`` planted (none for None)."""
    if name is None:
        yield
        return
    if name in TRAIN_FAULTS:
        from repro_torch.train import step as mod
        target, fn = {"frozen_state": ("adamw_update", _frozen),
                      "half_batch": ("rank_grads", _half),
                      "no_exchange": ("sync_grads", _no_exchange)}[name]
    elif name in SERVE_FAULTS:
        from repro_torch.serve import engine as mod
        target, fn = "sample", _altered
    else:
        raise ValueError(f"unknown fault {name!r}")
    with _swap(mod, target, fn):
        yield
