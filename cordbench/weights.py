"""Weights made from the seed, on the device, in the port's parameter layout.

The benchmark makes the weights; the program and the plain reference both
read the same tensors.  Every leaf is a view into one float32 buffer that
a device generator fills from the seed in a few large calls, then scaled
to its layer's law (fan-in normal for kernels, mamba's S4D-real `A_log`
and log-uniform time steps).  The layout is the one `repro_torch`'s
`init` returns: per-layer leaves stacked on a leading layer axis, keys as
in `models/transformer.py` and `models/hybrid.py`.
"""

from __future__ import annotations

import math

import torch

# elements a single fill call draws: large calls, each well inside the
# generator's 32-bit offsets
_FILL = 1 << 28


def layout(cfg) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """``(path, shape, law, scale)`` of every leaf of ``cfg``'s parameters,
    in sorted-key order.  Laws: ``normal`` (scale = std), ``norm`` (RMSNorm
    scale, normal of std ``scale``), ``ones``, ``a_log``, ``dt_bias``."""
    a = cfg.attention
    d, L = cfg.d_model, cfg.num_layers
    hd = a.head_dim or d // a.num_heads
    leaves = [(("embed", "tok"), (cfg.vocab_size, d), "normal", 1.0 / d),
              (("final_norm", "scale"), (d,), "norm", 0.1)]
    lay = [(("norm1", "scale"), (L, d), "norm", 0.1),
           (("norm2", "scale"), (L, d), "norm", 0.1),
           (("attn", "wq"), (L, d, a.num_heads, hd), "normal", d ** -0.5),
           (("attn", "wk"), (L, d, a.num_kv_heads, hd), "normal", d ** -0.5),
           (("attn", "wv"), (L, d, a.num_kv_heads, hd), "normal", d ** -0.5),
           (("attn", "wo"), (L, a.num_heads * hd, d), "normal",
            (a.num_heads * hd) ** -0.5)]
    f = cfg.d_ff
    if cfg.family == "moe":
        e = cfg.moe.num_experts
        lay += [(("moe", "router"), (L, d, e), "normal", 1e-2),
                (("moe", "wi"), (L, e, d, f), "normal", d ** -0.5),
                (("moe", "wg"), (L, e, d, f), "normal", d ** -0.5),
                (("moe", "wo"), (L, e, f, d), "normal", f ** -0.5)]
    elif cfg.family in ("dense", "hybrid"):
        lay += [(("mlp", "wi"), (L, d, f), "normal", d ** -0.5),
                (("mlp", "wg"), (L, d, f), "normal", d ** -0.5),
                (("mlp", "wo"), (L, f, d), "normal", f ** -0.5)]
    else:
        raise ValueError(f"no weight layout for the {cfg.family!r} family")
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        r = s.dt_rank or math.ceil(d / 16)
        lay += [(("attn_norm", "scale"), (L, d), "norm", 0.1),
                (("mamba_norm", "scale"), (L, d), "norm", 0.1),
                (("mamba", "in_proj"), (L, d, 2 * di), "normal", d ** -0.5),
                (("mamba", "conv"), (L, s.conv_width, di), "normal",
                 s.conv_width ** -0.5),
                (("mamba", "conv_bias"), (L, di), "normal", 0.02),
                (("mamba", "x_proj"), (L, di, r + 2 * s.state_size), "normal",
                 di ** -0.5),
                (("mamba", "dt_proj"), (L, r, di), "normal", r ** -0.5),
                (("mamba", "dt_bias"), (L, di), "dt_bias", 0.0),
                (("mamba", "A_log"), (L, di, s.state_size), "a_log", 0.0),
                (("mamba", "D"), (L, di), "ones", 0.0),
                (("mamba", "out_proj"), (L, di, d), "normal", di ** -0.5)]
    leaves += [(("layers",) + p, shape, law, sc) for p, shape, law, sc in lay]
    return sorted(leaves, key=lambda t: t[0])


def make(cfg, seed: int, device) -> dict:
    """The parameters of ``cfg`` drawn from ``seed`` on ``device``: one
    float32 buffer, filled by normal draws of at most 2^28 elements, its
    leaves scaled or overwritten by their law."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spec = layout(cfg)
    flat = torch.empty(sum(math.prod(s) for _, s, _, _ in spec),
                       dtype=torch.float32, device=device)
    for lo in range(0, flat.numel(), _FILL):
        flat[lo:lo + _FILL].normal_(generator=gen)
    params: dict = {}
    off = 0
    for path, shape, law, scale in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if law in ("normal", "norm"):
            leaf.mul_(scale)
        elif law == "ones":
            leaf.fill_(1.0)
        elif law == "a_log":
            n_state = shape[-1]
            leaf.copy_(torch.log(torch.arange(
                1, n_state + 1, dtype=torch.float32, device=device)))
        elif law == "dt_bias":
            # mamba's time steps, log-uniform in [1e-3, 1e-1], stored as
            # their inverse softplus
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            raise ValueError(f"unknown law {law!r}")
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def leaves(params: dict, prefix: tuple[str, ...] = ()) -> list:
    """``(path, tensor)`` pairs in sorted-key order."""
    out = []
    for key in sorted(params):
        v = params[key]
        if isinstance(v, dict):
            out += leaves(v, prefix + (key,))
        else:
            out.append((prefix + (key,), v))
    return out
