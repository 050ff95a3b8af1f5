"""AdamW with warmup-cosine schedule and global-norm clipping, over
nested dicts of tensors in ``jax.tree``'s leaf order (``core/tree.py``).

``repro`` jits its steps with the train state donated, so XLA reuses
the state's buffers for the new one.  Here :func:`adamw_update` does the
same by hand: it writes the parameters and both moments in place, leaf by
leaf, with the operations of the out-of-place formula in the same order
(so every value is bit for bit that formula's), and returns the same
dicts.  A caller that needs a state after a step clones it first.  The
step counter, the learning rate and the clipping scale stay tensors on
the parameters' device, so an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: dict
    nu: dict


def warmup_cosine(cfg: TrainConfig, total_steps: int | None = None):
    """``schedule(step)``: the float32 learning rate at ``step`` (an int
    or an int tensor), as a float32 tensor."""
    total = total_steps or max(cfg.steps, 1)

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(total - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return cfg.learning_rate * warm * (0.1 + 0.9 * cos)

    return schedule


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(clipped grads, global norm)``; ``max_norm <= 0`` keeps them."""
    leaves = [g for _, g in tree_flatten(grads)]
    if max_norm <= 0:
        return grads, torch.zeros((), dtype=torch.float32,
                                  device=leaves[0].device)
    total = 0
    for g in leaves:
        total = total + g.float().square().sum()
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_init(params: dict, opt_dtype: str = "float32") -> AdamWState:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opt_dtype]
    zeros = lambda t: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), t)
    dev = tree_flatten(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(params), nu=zeros(params))


def adamw_update(grads: dict, state: AdamWState, params: dict,
                 cfg: TrainConfig, schedule=None):
    """Returns (params, new_state, stats): ``params`` and the moments of
    ``state`` written in place (the returned dicts are the given ones),
    the step counter a new tensor."""
    schedule = schedule or warmup_cosine(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd_(p, g, m, v):
        # the out-of-place formula, each product rounded on its own (no
        # fused multiply-add, so no add_(alpha=) / addcmul_ / lerp_):
        #   m32 = b1 * m + (1 - b1) * g;  v32 = b2 * v + (1 - b2) * g^2
        #   p  -= lr * (m32 / bc1 / (sqrt(v32 / bc2) + eps) + wd * p)
        g = g.float()
        m32 = m.float().mul_(b1).add_((1 - b1) * g)    # m itself if f32
        v32 = v.float().mul_(b2).add_((1 - b2) * g.square())
        den = (v32 / bc2).sqrt_().add_(eps)
        delta = (m32 / bc1).div_(den).add_(wd * p.float())
        del den
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - delta.mul_(lr))

    g_l = tree_leaves(grads)
    m_l = tree_leaves(state.mu)
    v_l = tree_leaves(state.nu)
    for p, g, m, v in zip(tree_leaves(params), g_l, m_l, v_l):
        upd_(p, g, m, v)
    stats = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), stats


__all__ = ["AdamWState", "adamw_init", "adamw_update", "warmup_cosine",
           "clip_by_global_norm"]
