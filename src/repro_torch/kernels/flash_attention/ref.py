"""Plain-torch versions of the flash-attention kernels.

* :func:`flash_attention_ref` — the forward's oracle: deliberately naive
  (materializes the full logits matrix) and written independently of
  ``layers/attention.py``, like ``repro``'s ``ref.py``.
* :func:`flash_attention_bwd_plain` — the backward kernel's plain
  version: a port of ``repro``'s blockwise ``_flash_bwd`` (the
  custom-VJP partner of its Pallas forward).
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


def _blocking(sq: int, skv: int, q_block: int, kv_block: int):
    qb = min(q_block, sq)
    while sq % qb:
        qb -= 1
    kb = min(kv_block, skv)
    while skv % kb:
        kb -= 1
    return qb, kb


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool, window,
                              logit_cap: float = 0.0, q_block: int = 512,
                              kv_block: int = 1024):
    """(dq, dk, dv) of whole-sequence attention (positions 0..S-1) from
    the forward's ``o`` and ``lse`` (B, KVH, G, Sq): ``repro``'s
    ``_flash_bwd``, block by block in the same order (kv blocks outer, q
    blocks inner), the probabilities recomputed from the saved lse,
    ``delta = rowsum(do * o)``, the soft cap's derivative, all in float32
    and cast to the inputs' dtypes at the end."""
    from repro_torch.layers.attention import make_mask
    from repro_torch.layers.common import softcap as _softcap

    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qb, kb = _blocking(sq, skv, q_block, kv_block)
    dev = q.device
    delta = (do.float() * o.float()).sum(-1)                  # (b, sq, h)
    delta = delta.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)  # (b,kvh,g,sq)
    qg = q.reshape(b, sq, kvh, g, d).float()
    dog = do.reshape(b, sq, kvh, g, d).float()
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(sq, dtype=torch.int32, device=dev)
    k_pos = torch.arange(skv, dtype=torch.int32, device=dev)
    dq = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, skv, kvh, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, skv, kvh, d), dtype=torch.float32, device=dev)
    for j in range(0, skv, kb):
        kj, vj = kf[:, j:j + kb], vf[:, j:j + kb]
        for i in range(0, sq, qb):
            qi, doi = qg[:, i:i + qb], dog[:, i:i + qb]
            raw = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            logits = _softcap(raw * scale, logit_cap)
            mask = make_mask(q_pos[i:i + qb], k_pos[j:j + kb],
                             causal=causal, window=window)
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
            p = torch.exp(logits - lse[..., i:i + qb, None])
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doi, vj)
            ds = p * (dp - delta[..., i:i + qb, None])
            if logit_cap > 0:   # soft cap's derivative: 1 - tanh(raw/cap)^2
                ds = ds * (1.0 - torch.square(torch.tanh(
                    raw * scale / logit_cap)))
            dq[:, i:i + qb] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                            kj) * scale
            dk[:, j:j + kb] += torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                            qi) * scale
            dv[:, j:j + kb] += torch.einsum("bhgqk,bqhgd->bkhd", p, doi)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


__all__ = ["flash_attention_ref", "flash_attention_bwd_plain", "NEG_INF"]
