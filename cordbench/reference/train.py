"""Plain reference of the training steps: the mean loss over the global
batch, its gradient, clipping by global norm, AdamW with the
warmup-cosine learning rate, written out from their published formulas.

What it reports is what the check compares with the program: each step's
loss, the per-leaf norms of the first step's gradient as the optimizer
takes it (after clipping), and the per-leaf norms of the parameters'
change over the steps.
"""

from __future__ import annotations

import math

import torch

from cordbench.reference.common import Precision


def leaves(tree: dict, prefix: tuple = ()) -> list:
    out = []
    for key in sorted(tree):
        v = tree[key]
        out += leaves(v, prefix + (key,)) if isinstance(v, dict) else \
            [(prefix + (key,), v)]
    return out


def learning_rate(step: int, t: dict) -> float:
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine to a tenth of it at ``steps``."""
    warm = min(step / max(t["warmup_steps"], 1), 1.0)
    prog = min(max((step - t["warmup_steps"])
                   / max(t["steps"] - t["warmup_steps"], 1), 0.0), 1.0)
    return t["learning_rate"] * warm * (0.1 + 0.9 * 0.5
                                        * (1.0 + math.cos(math.pi * prog)))


def train(loss_fn, params: dict, mcfg: dict, batches: list, t: dict,
          prec: Precision | None = None, rows: int = 1) -> dict:
    """Run ``len(batches)`` steps of ``loss_fn(params, mcfg, tokens,
    labels, prec)`` (the family's plain loss) on ``params`` (updated in
    place) from zero moments.  Each batch is ``(tokens, labels)`` of the
    global batch; its gradient is summed over blocks of ``rows`` rows,
    each block's mean loss weighted by its share of the rows."""
    prec = prec or Precision()
    named = leaves(params)
    ps = [p.requires_grad_(True) for _, p in named]
    start = [p.detach().clone() for p in ps]
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    losses, first = [], None
    b1, b2, eps, wd = t["b1"], t["b2"], t["eps"], t["weight_decay"]
    for step, (tokens, labels) in enumerate(batches, start=1):
        n = tokens.shape[0]
        total = 0.0
        for r in range(0, n, rows):
            part = loss_fn(params, mcfg, tokens[r:r + rows],
                           labels[r:r + rows], prec) * (min(rows, n - r) / n)
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [p.grad for p in ps]
            gn = math.sqrt(sum(float(g.double().square().sum())
                               for g in grads))
            if t["grad_clip"] > 0:
                scale = min(t["grad_clip"] / max(gn, 1e-9), 1.0)
                for g in grads:
                    g.mul_(scale)
            if first is None:
                first = {"/".join(path): float(g.norm())
                         for (path, _), g in zip(named, grads)}
            lr = learning_rate(step, t)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for p, g, m, v in zip(ps, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                p.sub_(lr * ((m / bc1) / ((v / bc2).sqrt() + eps) + wd * p))
                p.grad = None
    with torch.no_grad():
        change = {"/".join(path): float((p - s).norm())
                  for (path, _), p, s in zip(named, ps, start)}
    for p in ps:
        p.requires_grad_(False)
    return {"losses": losses, "grad1": first, "change": change}
