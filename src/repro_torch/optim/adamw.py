"""AdamW with warmup-cosine schedule and global-norm clipping, over
nested dicts of tensors in ``jax.tree``'s leaf order (``core/tree.py``).

Pure functions as in ``repro``: the update returns new parameters and
moments and never writes its inputs.  The step counter, the learning
rate and the clipping scale stay tensors on the parameters' device, so
an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


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
    """Returns (new_params, new_state, stats)."""
    schedule = schedule or warmup_cosine(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.float()
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g.square()
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m32.to(m.dtype),
                v32.to(v.dtype))

    flat = tree_flatten(params)
    paths = [path for path, _ in flat]
    g_l = [g for _, g in tree_flatten(grads)]
    m_l = [m for _, m in tree_flatten(state.mu)]
    v_l = [v for _, v in tree_flatten(state.nu)]
    out = [upd(p, g, m, v) for (_, p), g, m, v in zip(flat, g_l, m_l, v_l)]
    new_p = tree_unflatten(paths, [o[0] for o in out])
    new_m = tree_unflatten(paths, [o[1] for o in out])
    new_v = tree_unflatten(paths, [o[2] for o in out])
    stats = {"lr": lr, "grad_norm": gnorm}
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), stats


__all__ = ["AdamWState", "adamw_init", "adamw_update", "warmup_cosine",
           "clip_by_global_norm"]
