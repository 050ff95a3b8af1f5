"""Pieces the plain references share: matrix products at a stated
precision, RMSNorm, rotary positions, blocked causal attention."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` under one scale for the tensor,
    its largest magnitude mapped to the format's largest, ``top``."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """An operand of a product rounded to float8 as fp8 training rounds
    them: e4m3 forward, its gradient e5m2, each under one scale a
    tensor."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


class Precision:
    """Matrix products in float32 (``"float32"``) or from float8 operands
    (``"fp8"``: e4m3 forward and e5m2 gradients, one scale a tensor),
    accumulated in float32.  Everything else stays float32."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x if self.kind == "float32" else _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.q(a), self.q(b))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions while the reference
    runs; the previous settings come back after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """x / rms(x) * (1 + scale), in float32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (B, S, H, D) by positions (S,): the first and second halves of
    each head are the pair's two coordinates."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = pos.float()[:, None] * freqs                   # (S, D/2)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, p: dict, *, heads: int, kv_heads: int, theta: float,
              window: int, cap: float, prec: Precision,
              q_block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention of (B, S, D) from position 0, with
    an optional window (a query sees keys less than ``window`` behind it)
    and a tanh soft cap on the scaled logits; query head h reads kv head
    h // (heads / kv_heads).  Queries go in blocks of ``q_block`` against
    the keys they can see."""
    b, s, d = x.shape
    hd = p["wq"].shape[-1]
    pos = torch.arange(s, device=x.device)
    q = prec.mm(x, p["wq"].reshape(d, heads * hd)).view(b, s, heads, hd)
    k = prec.mm(x, p["wk"].reshape(d, kv_heads * hd)).view(b, s, kv_heads,
                                                             hd)
    v = prec.mm(x, p["wv"].reshape(d, kv_heads * hd)).view(b, s, kv_heads,
                                                             hd)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    g = heads // kv_heads
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    outs = []
    for qs in range(0, s, q_block):
        qe = min(s, qs + q_block)
        ks = max(0, qs - window + 1) if window else 0
        logits = prec.einsum("bqhd,bkhd->bhqk", q[:, qs:qe],
                             k[:, ks:qe]) / math.sqrt(hd)
        if cap > 0:
            logits = cap * torch.tanh(logits / cap)
        qp, kp = pos[qs:qe, None], pos[None, ks:qe]
        ok = kp <= qp
        if window:
            ok = ok & (qp - kp < window)
        logits = logits.masked_fill(~ok, float("-inf"))
        outs.append(prec.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1),
                                v[:, ks:qe]))
    o = torch.cat(outs, dim=1).reshape(b, s, heads * hd)
    return prec.mm(o, p["wo"])


def layer_windows(mcfg: dict) -> list[int]:
    """Each layer's attention window (0 = global): with a local:global
    ratio r, every (r+1)-th layer is global; a hybrid model with a window
    attends globally at its first, middle and last layers; otherwise the
    window, or none, holds for every layer."""
    a = mcfg["attention"]
    n, w = mcfg["num_layers"], a["sliding_window"]
    if w and a["local_global_ratio"] > 0:
        r = a["local_global_ratio"]
        return [0 if i % (r + 1) == r else w for i in range(n)]
    if w and mcfg["family"] == "hybrid":
        return [0 if i in (0, n // 2, n - 1) else w for i in range(n)]
    return [w] * n


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def unstack(params: dict) -> list[dict]:
    """Every layer's leaves, the stacked leaves split once by unbind (so a
    gradient lands in its stacked leaf once, not through a zero-filled
    copy a layer)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v.unbind(0)
    walk(params, ())
    n = len(next(iter(flat.values())))
    out = []
    for i in range(n):
        lp: dict = {}
        for path, parts in flat.items():
            node = lp
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = parts[i]
        out.append(lp)
    return out
