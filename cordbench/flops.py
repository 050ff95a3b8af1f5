"""The benchmark's yardstick: operations and bytes of the port's kernels and
of whole model steps, computed from shapes, and the H100's peaks.

A kernel's least time is the larger of its operations over the peak of
the kind of operation it does and its bytes over the memory bandwidth;
each input byte is counted once and each output byte once.  Peaks are
NVIDIA's H100 SXM data sheet's, dense.  Model FLOPs count the operations
the model needs (matrix products, attention scores, the scan), not what
a kernel recomputes or pads.
"""

from __future__ import annotations

import functools
import math

BF16_FLOPS = 989e12        # matrix products on bf16 inputs
TF32_FLOPS = 495e12        # matrix products on f32 inputs (TF32)
F32_FLOPS = 67e12          # other float32 work
HBM_BYTES_PER_S = 3.35e12

SCAN_FLOPS_PER_STATE_STEP = 6      # dt*a, exp, *h, dt*x*b, +, *c
SCAN_BWD_FLOPS_PER_STATE_STEP = 20


def least_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool = True,
                    window: int = 0) -> int:
    """(query, key) pairs that whole-sequence attention scores: query i of
    0..sq-1 sees keys up to i when causal, and from i - window + 1 on with
    a window."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_fwd(b: int, s: int, heads: int, kv_heads: int, d: int, *,
              window: int = 0, elem: int = 2, lse: bool = False):
    """(operations, bytes) of one causal flash forward over (b, s): two
    products of 2 d operations a pair a head; q, k, v read and o written
    once, the float32 lse written once when kept."""
    ops = 4 * d * heads * b * attention_pairs(s, s, True, window)
    nbytes = (2 * b * s * heads + 2 * b * s * kv_heads) * d * elem
    return ops, nbytes + (4 * b * heads * s if lse else 0)


def flash_bwd(b: int, s: int, heads: int, kv_heads: int, d: int, *,
              window: int = 0, elem: int = 2):
    """(operations, bytes) of one causal flash backward: five products of
    2 d operations a pair a head; q, k, v, o, dO and the lse read once,
    dq, dk, dv written once."""
    ops = 10 * d * heads * b * attention_pairs(s, s, True, window)
    nbytes = (4 * b * s * heads + 4 * b * s * kv_heads) * d * elem
    return ops, nbytes + 4 * b * heads * s


def scan_bwd(b: int, s: int, di: int, n: int, *, elem: int = 4):
    """(operations, bytes) of one selective-scan backward: 20 operations
    a state element a step; dt, x, the output cotangent, d dt and d x once
    each, b, c, d b, d c, a, d a, h0, the final state's cotangent and
    d h0 in float32."""
    nbytes = 5 * b * s * di * elem + 4 * (4 * b * s * n + 2 * di * n
                                          + 3 * b * di * n)
    return SCAN_BWD_FLOPS_PER_STATE_STEP * b * s * di * n, nbytes


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def _head_dim(m: dict) -> int:
    a = m["attention"]
    return a["head_dim"] or m["d_model"] // a["num_heads"]


def layer_matmul_params(m: dict) -> int:
    """Weights one token multiplies in one layer: attention projections,
    the MLP, or the router and the top-k experts, and the mamba
    projections."""
    a, d, f = m["attention"], m["d_model"], m["d_ff"]
    hd = _head_dim(m)
    n = d * hd * (2 * a["num_heads"] + 2 * a["num_kv_heads"])
    mats = 3 if m["gated_mlp"] else 2
    if m["family"] == "moe":
        e = m["moe"]["num_experts"]
        n += d * e + mats * d * f * m["moe"]["top_k"]
    else:
        n += mats * d * f
    if m["family"] == "hybrid":
        s = m["ssm"]
        di = s["expand"] * d
        r = s["dt_rank"] or math.ceil(d / 16)
        n += d * 2 * di + di * (r + 2 * s["state_size"]) + r * di + di * d
    return n


def forward_token_flops(m: dict) -> int:
    """Matrix-product FLOPs of one token through every layer, without
    attention scores and the vocabulary projection."""
    return 2 * m["num_layers"] * layer_matmul_params(m)


def head_flops(m: dict) -> int:
    return 2 * m["vocab_size"] * m["d_model"]


def serve_request_flops(m: dict, prompt: int, new: int) -> int:
    """Model FLOPs of serving one request: its prompt tokens (no padding)
    and ``new`` output tokens through every layer, each output token's
    logits, and causal attention over the context each position sees."""
    tokens = prompt + max(new - 1, 0)       # the last token is not fed
    pairs = tokens * (tokens + 1) // 2
    a = m["attention"]
    return (tokens * forward_token_flops(m) + new * head_flops(m)
            + m["num_layers"] * 4 * _head_dim(m) * a["num_heads"] * pairs)


def train_step_flops(m: dict, batch: int, seq: int,
                     windows: list[int]) -> int:
    """Model FLOPs of one training step on (batch, seq): 6 per matrix
    weight a token (forward and backward, the tied vocabulary projection
    included), 3x the forward attention scores of every layer under its
    window, and 3x the scan's forward; recomputation is not counted."""
    tokens = batch * seq
    mm = m["num_layers"] * layer_matmul_params(m) + m["vocab_size"] \
        * m["d_model"]
    a = m["attention"]
    att = 0
    for w in windows:
        att += 4 * _head_dim(m) * a["num_heads"] * batch \
            * attention_pairs(seq, seq, True, w)
    scan = 0
    if m["family"] == "hybrid":
        s = m["ssm"]
        scan = SCAN_FLOPS_PER_STATE_STEP * tokens * s["expand"] \
            * m["d_model"] * s["state_size"] * m["num_layers"]
    return 6 * mm * tokens + 3 * att + 3 * scan
