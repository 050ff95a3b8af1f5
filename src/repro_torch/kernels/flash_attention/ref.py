"""Plain-torch oracle for the flash-attention kernel.

Deliberately naive (materializes the full logits matrix) and written
independently of ``layers/attention.py``, like ``repro``'s ``ref.py``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0**30


def flash_attention_ref(q, k, v, *, window: int = 0,
                        valid_len: int | None = None, causal: bool = True,
                        logit_cap: float = 0.0, return_lse: bool = False):
    """q: (B, H, Sq, D); k/v: (B, KVH, Skv, D). Returns (B, H, Sq, D) in
    q's dtype, computed in float32; with ``return_lse`` also each row's
    natural-log log-sum-exp (B, H, Sq) float32 of its scaled, soft-capped,
    masked logits."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    if valid_len is None:
        valid_len = skv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)

    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if logit_cap > 0:
        logits = logit_cap * torch.tanh(logits / logit_cap)

    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos < valid_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))

    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p * mask  # fully-masked rows -> 0 (flash convention), not uniform
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1)
    return o


__all__ = ["flash_attention_ref", "NEG_INF"]
