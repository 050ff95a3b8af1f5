"""Grouped-query attention with causal / sliding-window masking, RoPE,
qk-norm and logit softcap — the forward pass.

Layouts: activations (B, S, H, D); KV (B, S, KVH, D); GQA groups the H
query heads into KVH groups of size G = H // KVH.

:func:`attend` takes the flash-attention kernel
(``kernels/flash_attention``) for whole-sequence attention with positions
0..S-1 and no per-key validity — the prefill and the training forward —
and the plain masked softmax (:func:`attend_naive`) for the decode and
chunk modes, which JAX also computes outside its Pallas kernel.

With gradients wanted, whole-sequence attention is :class:`FlashAttention`,
an autograd function: its forward is the kernel with its log-sum-exp, its
backward :func:`flash_attention_bwd`, the flash backward kernel (its
plain version on the CPU: a port of ``repro``'s blockwise ``_flash_bwd``,
which ``repro`` computes outside any Pallas kernel).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.layers.common import constrain, dense_init, rmsnorm
from repro_torch.layers.common import softcap as _softcap

NEG_INF = -2.0**30   # large-negative for masking (safe in bf16 after cast)


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qk_norm: bool = False,
                   device=None) -> dict:
    p = {
        "wq": dense_init(gen, d_model, num_heads, head_dim, device=device),
        "wk": dense_init(gen, d_model, num_kv_heads, head_dim, device=device),
        "wv": dense_init(gen, d_model, num_kv_heads, head_dim, device=device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, device=device,
                         scale=1.0 / math.sqrt(num_heads * head_dim)),
    }
    if qk_norm:
        p["q_norm"] = {"scale": torch.zeros((head_dim,), dtype=torch.float32,
                                            device=device)}
        p["k_norm"] = {"scale": torch.zeros((head_dim,), dtype=torch.float32,
                                            device=device)}
    return p


def qkv_project(params: dict, x: torch.Tensor, *, num_kv_heads: int,
                positions: torch.Tensor, theta, qk_norm: bool, eps: float,
                dp=None, kv_input: torch.Tensor | None = None):
    """Project to q, k, v (with RoPE + optional qk-norm applied).

    ``kv_input`` (cross-attention) routes the k/v projections off another
    sequence (the encoder's output); positions then rotate only q."""
    xkv = x if kv_input is None else kv_input
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhe->bshe", xkv, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhe->bshe", xkv, params["wv"].to(x.dtype))
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, eps)
        k = rmsnorm(params["k_norm"], k, eps)
    if theta is not None:
        from repro_torch.layers.rope import apply_rope
        q = apply_rope(q, positions, theta)
        if kv_input is None:
            k = apply_rope(k, positions, theta)
    q = constrain(dp, q, ("batch", "seq", "heads", "head_dim"), tag="attn/q")
    k = constrain(dp, k, ("batch", "seq", "kv_heads", "head_dim"), tag="attn/k")
    v = constrain(dp, v, ("batch", "seq", "kv_heads", "head_dim"), tag="attn/v")
    return q, k, v


def output_project(params: dict, o: torch.Tensor, dp=None) -> torch.Tensor:
    b, s, h, d = o.shape
    out = torch.matmul(o.reshape(b, s, h * d), params["wo"].to(o.dtype))
    return constrain(dp, out, ("batch", "seq", "embed"), tag="attn/out")


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window=None, k_valid: torch.Tensor | None = None):
    """Boolean mask (Sq, Sk) from 1-D position vectors; ``window`` 0 or
    None means no window (global layers)."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    # the shape written out: torch.broadcast_shapes imports torch._refs on
    # its first call, a one-time stall of seconds on the host
    mask = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < int(window)
    if k_valid is not None:
        mask = mask & k_valid[..., None, :]
    return mask


def attend_naive(q, k, v, mask, *, logit_cap: float = 0.0,
                 scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention: logits in float32 (exact products of the
    working-dtype inputs), probabilities cast to v's dtype for the second
    product.  ``mask`` is (Sq, Sk), (B, Sq, Sk) or broadcastable."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    logits = _softcap(logits, logit_cap)
    if mask.dim() == 2:        # (Sq, Sk) from 1-D positions
        mask = mask[None, None, None]
    elif mask.dim() == 3:      # (B, Sq, Sk)
        mask = mask[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, d)


@functools.lru_cache(maxsize=64)
def prefill_positions(n: int, device: torch.device) -> torch.Tensor:
    """Positions 0..n-1 (int32) of a whole-sequence prefill on ``device``.
    One tensor per (n, device), shared and never written: :func:`attend`
    recognises it by identity, with no device-to-host read."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _check_iota(pos: torch.Tensor, n: int, what: str) -> None:
    if pos is prefill_positions(n, pos.device):
        return
    iota = torch.arange(n, dtype=pos.dtype, device=pos.device)
    if pos.dim() != 1 or pos.shape[0] != n or not torch.equal(pos, iota):
        raise ValueError(f"flash attention needs {what} positions 0..{n - 1}"
                         f" (whole-sequence prefill)")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, window,
                        logit_cap: float = 0.0, q_block: int = 512,
                        kv_block: int = 1024):
    """(dq, dk, dv) of whole-sequence attention (positions 0..S-1) from
    the forward's ``o`` and ``lse`` (B, KVH, G, Sq):
    ``kernels/flash_attention.ops.flash_attention_bwd``, the Hopper
    backward kernel on a CUDA tensor and its plain version
    (``ref.flash_attention_bwd_plain``, ``repro``'s blockwise
    ``_flash_bwd`` in ``q_block`` x ``kv_block`` blocks) on the CPU."""
    from repro_torch.kernels.flash_attention import ops
    return ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, logit_cap=logit_cap,
                                   q_block=q_block, kv_block=kv_block)


class FlashAttention(torch.autograd.Function):
    """Whole-sequence attention with a gradient.  On a CUDA tensor the
    forward is the flash kernel with its log-sum-exp and the backward the
    flash backward kernel (:func:`flash_attention_bwd`); on the CPU both
    take their plain versions.  With ``plain=True`` both are the plain
    versions on any device, so the card can hold the kernels against them
    inside the same function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, plain):
        from repro_torch.kernels.flash_attention import ops
        fwd = ops.flash_attention_plain if plain else ops.flash_attention
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fwd(q, k, v, causal=causal, window=int(window or 0),
                     logit_cap=logit_cap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, logit_cap, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention import ref
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, logit_cap, plain = ctx.opts
        bwd = ref.flash_attention_bwd_plain if plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         logit_cap=logit_cap)
        return dq, dk, dv, None, None, None, None


def attend(q, k, v, *, q_pos, k_pos, causal: bool = True, window=None,
           logit_cap: float = 0.0, k_valid=None, impl: str = "flash"):
    """Attention over (B, S, H, D) activations.

    ``impl="flash"`` without ``k_valid`` is whole-sequence attention: it
    goes through ``kernels/flash_attention`` (the Hopper kernel on a CUDA
    tensor, its plain version on the CPU), which assumes positions
    0..S-1 — checked here (for free when the positions are
    :func:`prefill_positions`, by value otherwise).  When q, k or v wants
    a gradient it is :class:`FlashAttention`.  ``impl="plain"`` is the
    same with the kernel's plain version as the forward, on any device.
    With ``k_valid`` (decode / chunk modes) or ``impl="naive"`` it is the
    plain masked softmax."""
    if impl not in ("flash", "plain", "naive"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl != "naive" and k_valid is None:
        _check_iota(q_pos, q.shape[1], "query")
        _check_iota(k_pos, k.shape[1], "key")
        plain = impl == "plain"
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                        plain)
        from repro_torch.kernels.flash_attention import ops
        fwd = ops.flash_attention_plain if plain else ops.flash_attention
        return fwd(q, k, v, causal=causal, window=int(window or 0),
                   logit_cap=logit_cap)
    qp = q_pos[0] if q_pos.dim() == 2 else q_pos
    mask = make_mask(qp, k_pos, causal=causal, window=window, k_valid=k_valid)
    return attend_naive(q, k, v, mask, logit_cap=logit_cap)


__all__ = [
    "attention_init", "qkv_project", "output_project", "make_mask",
    "attend", "attend_naive", "prefill_positions", "FlashAttention",
    "flash_attention_bwd", "NEG_INF",
]
