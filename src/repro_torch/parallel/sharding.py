"""Logical-axis sharding rules (DP/TP/EP/SP over pod/data/model) and
per-parameter partition specs.

Activations are constrained through the dataplane with *logical* names
("batch", "heads", "mlp", ...); these rule tables map them to mesh axes.
Parameters get specs from path-pattern rules (:func:`param_specs`),
TP-sharding attention heads, MLP hidden, vocab and experts over the
``model`` axis, with optional FSDP sharding of the remaining large dim
over ``data``.  The rules are ``repro``'s, over shapes only.

The port runs on one card, so a spec is metadata: the dataplane records
it on every edge (``Dataplane.spec``) and the GSPMD step checks the
state's and batch's specs against their shapes; placing a tensor on a
one-card mesh is the identity.  :class:`PartitionSpec` stands in for
``jax.sharding.PartitionSpec``: a tuple with one entry per leading dim,
each None, an axis name or a tuple of names.

Shape-cell specialisations:
  * train / prefill / decode: batch → (pod, data)
  * long-context decode (batch=1): KV sequence → (data, model) —
    sequence-parallel attention.
"""

from __future__ import annotations

import re

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tree import tree_flatten, tree_unflatten

DATA = "data"
MODEL = "model"
POD = "pod"


def _entry(e):
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a sequence of
    one axis is that axis, an empty one None, a longer one a tuple."""
    if isinstance(e, (tuple, list)):
        return None if not e else (e[0] if len(e) == 1 else tuple(e))
    return e


class PartitionSpec(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``
    and replicates dim 1; dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

def activation_rules(cfg: ModelConfig, shape: ShapeConfig, *,
                     multi_pod: bool = False,
                     seq_shard_prefill: bool = True,
                     model_size: int = 16) -> dict:
    """Logical-name -> mesh-axis rules for activation constraints.

    Head axes are only mapped to ``model`` when the head count is at least
    the axis size (GSPMD pads the remainder, ≤2× waste); below that the
    padding blow-up is worse than replicating the attention activations
    (KVH=1 padded to 16 holds 16 copies of K)."""
    batch_axes = (POD, DATA) if multi_pod else (DATA,)
    long_ctx = shape.kind == "decode" and shape.global_batch == 1
    a = cfg.attention
    rules = {
        "batch": batch_axes if not long_ctx else None,
        "seq": None,
        "embed": None,
        # heads shard only when there are at least as many as the axis
        # has ranks: padding 8 heads to 16 adds padded q/k reshards
        "heads": MODEL if a.num_heads >= model_size else None,
        "kv_heads": MODEL if a.num_kv_heads >= model_size else None,
        "mlp": MODEL,
        "expert_mlp": None,
        "vocab": MODEL,
        "experts": MODEL,
        "exp_groups": batch_axes,
        "kv_seq": None,
        "head_dim": None,
        # sequence-parallel residual stream (Megatron-SP): the residual /
        # norm segments and the remat-saved layer inputs shard over model,
        # re-gathered inside attention/MLP by GSPMD (reduce-scatter +
        # all-gather replaces the post-projection psum).
        "seq_resid": MODEL if shape.kind in ("train", "prefill") else None,
    }
    if shape.kind == "decode":
        # decode activations are (B, 1, H, hd) — tiny; constraining them on
        # heads only forces weight-side resharding and padding
        rules["heads"] = None
        rules["kv_heads"] = None
    rules["cache_head_dim"] = None
    if rules["kv_heads"] is None and not long_ctx and \
            shape.kind in ("decode", "prefill"):
        # KV heads don't divide the model axis: shard the KV *cache* over
        # head_dim instead — dynamic cache updates stay local, GSPMD adds a
        # small psum on decode logits (without it the caches of the
        # large presets replicate)
        rules["cache_head_dim"] = MODEL
        if shape.kind == "decode":
            rules["head_dim"] = MODEL
    if long_ctx:
        # batch=1: shard the KV cache sequence across the whole mesh (SP)
        rules["kv_seq"] = (batch_axes + (MODEL,)) if multi_pod \
            else (DATA, MODEL)
        rules["heads"] = None
        rules["kv_heads"] = None
        rules["mlp"] = MODEL
    if shape.kind == "prefill" and seq_shard_prefill:
        # sequence parallelism only when the batch cannot fill the data
        # axis — sharding seq while replicating batch replicates every
        # activation
        data_size = 16
        if shape.global_batch < data_size:
            rules["seq"] = DATA
            rules["batch"] = (POD,) if multi_pod else None
            rules["exp_groups"] = (POD,) if multi_pod else None
    return rules


# ---------------------------------------------------------------------------
# parameter specs by path pattern
# ---------------------------------------------------------------------------

# (regex over the param path, spec for the LAST ndims of the leaf)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/(tok|head)$", (MODEL, None)),             # vocab-sharded tables
    (r"attn.*/(wq|wk|wv)$", (None, MODEL, None)),      # heads sharded
    (r"attn.*/wo$", (MODEL, None)),
    (r"(q_norm|k_norm)/scale$", (None,)),
    (r"moe/router$", (None, MODEL)),
    (r"moe/(wi|wg|wo)$", (MODEL, None, None)),         # experts sharded
    (r"moe/dense/(wi|wg)$", (None, MODEL)),
    (r"moe/dense/wo$", (MODEL, None)),
    (r"mlp/(wi|wg)$", (None, MODEL)),
    (r"mlp/wo$", (MODEL, None)),
    (r"ffn/(wi|wg)$", (None, MODEL)),
    (r"ffn/wo$", (MODEL, None)),
    (r"mamba/in_proj$", (None, MODEL)),
    (r"mamba/(out_proj|x_proj)$", (MODEL, None)),
    (r"mamba/dt_proj$", (None, MODEL)),
    (r"mamba/(conv|A_log)$", (None, MODEL) ),
    (r"mamba/(conv_bias|dt_bias|D)$", (MODEL,)),
    (r"core/up$", (None, MODEL)),
    (r"core/(down)$", (MODEL, None)),
    (r"core/(wq|wk|wv)$", (None, MODEL)),
    (r"core/conv$", (None, MODEL)),
    (r"core/(conv_bias)$", (MODEL,)),
    (r"core/w$", (None, MODEL)),
    (r"vision_proj$", (None, MODEL)),
    (r"frontend$", (None, None)),
]

_FSDP_BLOCKLIST = re.compile(r"(norm|bias|scale|b[if]?$|/D$|A_log|conv)")


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over a nested dict's leaves, in its nesting (a
    bare leaf is a tree with the empty path)."""
    pairs = tree_flatten(tree)
    if pairs == [((), tree)]:
        return fn((), tree)
    return tree_unflatten([p for p, _ in pairs],
                          [fn(p, leaf) for p, leaf in pairs])


def _axis_size(axis, mesh_sizes: dict) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh_sizes.get(a, 1)
        return n
    return mesh_sizes.get(axis, 1)


# Serving (decode/prefill) 2D expert sharding: experts over model AND the
# FFN dim over data, statically resident — no ZeRO-style regathers on the
# latency path.  Contractions over the data-sharded dim become psums.
_SERVE_MOE_RULES: list[tuple[str, tuple]] = [
    (r"moe/(wi|wg)$", (MODEL, None, DATA)),
    (r"moe/wo$", (MODEL, DATA, None)),
]


def spec_for_param(path: str, ndim: int, shape: tuple, *,
                   fsdp: bool = False, mesh_sizes: dict | None = None,
                   serve_moe_2d: bool = False) -> P:
    """Derive the PartitionSpec for a parameter leaf.

    ``mesh_sizes`` (axis name -> size): axes that do not divide the dim are
    dropped (in/out shardings must divide exactly, unlike constraints)."""
    mesh_sizes = mesh_sizes or {}

    def fits(i, axis):
        return shape[i] % _axis_size(axis, mesh_sizes) == 0

    rules = (_SERVE_MOE_RULES + _PARAM_RULES) if serve_moe_2d else _PARAM_RULES
    for pat, tail in rules:
        if re.search(pat, path):
            if len(tail) > ndim:
                return P()
            spec = [None] * (ndim - len(tail)) + list(tail)
            spec = [s if fits(i, s) else None for i, s in enumerate(spec)]
            if fsdp and not _FSDP_BLOCKLIST.search(path):
                # shard the largest remaining unsharded dim over data
                free = [i for i, s in enumerate(spec) if s is None]
                if free:
                    big = max(free, key=lambda i: shape[i])
                    if shape[big] >= 64 and fits(big, DATA):
                        spec[big] = DATA
            return P(*spec)
    return P()  # replicate by default (norms, biases, small tensors)


def param_specs(params_tree, *, fsdp: bool = False,
                mesh_sizes: dict | None = None, serve_moe_2d: bool = False):
    """PartitionSpec pytree matching ``params_tree`` (shapes or arrays)."""
    def leaf_spec(path, leaf):
        return spec_for_param(_path_str(path), leaf.ndim, tuple(leaf.shape),
                              fsdp=fsdp, mesh_sizes=mesh_sizes,
                              serve_moe_2d=serve_moe_2d)
    return _map_with_path(leaf_spec, params_tree)


def filter_spec(spec: P, shape: tuple, mesh_sizes: dict | None) -> P:
    """Drop spec axes that do not divide the corresponding dim exactly
    (required for jit in/out shardings, unlike constraints)."""
    if mesh_sizes is None:
        return spec
    out = []
    full = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for i, s in enumerate(full):
        out.append(s if shape[i] % _axis_size(s, mesh_sizes) == 0 else None)
    return P(*out)


def cache_spec_tree(cache_tree, rules: dict, mesh_sizes: dict | None = None):
    """Specs for decode caches: (L, B, S, KVH, hd) KV tensors get
    (None, batch, kv_seq, kv_heads, None); recurrent states get batch."""
    def leaf_spec(path, leaf):
        p = _path_str(path)
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", p) and leaf.ndim == 5:
            spec = P(None, rules.get("batch"), rules.get("kv_seq"),
                     rules.get("kv_heads"), rules.get("cache_head_dim"))
        elif leaf.ndim >= 2:
            spec = P(None, rules.get("batch"))
        else:
            spec = P()
        return filter_spec(spec, tuple(leaf.shape), mesh_sizes)
    return _map_with_path(leaf_spec, cache_tree)


def batch_specs(batch_tree, rules: dict, mesh_sizes: dict | None = None):
    """Specs for input batches: leading dim = batch, text dims replicated."""
    def leaf_spec(path, leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.ndim >= 2 and rules.get("seq") is not None:
            spec = P(rules.get("batch"), rules.get("seq"))
        else:
            spec = P(rules.get("batch"), *([None] * (leaf.ndim - 1)))
        return filter_spec(spec, tuple(leaf.shape), mesh_sizes)
    return _map_with_path(leaf_spec, batch_tree)


__all__ = [
    "DATA", "MODEL", "POD", "P", "PartitionSpec", "activation_rules",
    "param_specs", "spec_for_param", "filter_spec", "cache_spec_tree",
    "batch_specs",
]
