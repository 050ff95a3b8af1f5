"""Rematerialisation: a function run under ``torch.utils.checkpoint``,
its forward run again in the backward, with the dataplane told which pass
is the second.

``repro`` wraps a layer body in ``jax.checkpoint``: ``"full"`` saves
nothing and recomputes the body, ``"dots"`` (``checkpoint_dots``) saves
the outputs of the matrix products and recomputes the rest.  Here the
first is non-reentrant checkpointing and the second selective
checkpointing that saves the outputs of ``aten.mm``, ``bmm`` and
``addmm`` (``matmul`` and ``einsum`` reach these).  A recompute runs the
whole body: early stopping is off, so every dataplane edge in it launches
its cost kernel again, as XLA reruns a rematerialised body.  The edges of
the second pass run inside :meth:`Dataplane.recomputing`, so they are
not recorded twice.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

REMAT_MODES = ("none", "full", "dots")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def remat(policy: str, dp, fn, /, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward: all of them (``"full"``) or all but the matrix products'
    outputs (``"dots"``).  ``dp`` is the dataplane whose edges ``fn``
    issues, or None."""
    if policy not in ("full", "dots"):
        raise ValueError(f"remat policy must be 'full' or 'dots', got "
                         f"{policy!r}")

    def contexts():
        if policy == "dots":
            first, again = create_selective_checkpoint_contexts(_save_dots)
        else:
            first, again = contextlib.nullcontext(), contextlib.nullcontext()
        if dp is not None:
            again = _both(again, dp.recomputing())
        return first, again

    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=contexts, **kwargs)


__all__ = ["remat", "REMAT_MODES"]
