"""Mixture-of-Experts layer: top-k routing with block-wise capacity
dispatch (GShard-style "dropping" MoE), ``repro``'s ``layers/moe.py``.

Tokens are grouped into blocks; each block dispatches to every expert
with a per-block capacity C.  Training uses fixed capacity
(:func:`_capacity`, tokens beyond it are dropped); inference is dropless
(C = n·k over a block of at most 64 tokens), so each token's output does
not depend on which other rows share the batch — continuous batching ≡
gang decode and exact slot preempt / resume at temperature 0.

Parameters: ``router`` (D, E), ``wi`` / ``wg`` (E, D, F), ``wo`` (E, F, D),
and arctic's ``dense`` residual MLP.  The expert leaves meet the
activations in the activations' dtype: a caller that serves fixed
weights hands in the tree of :func:`held_experts`, whose expert leaves
were cast once for every layer (the serving engine does), and the layer
casts only a leaf that arrives in another dtype, on every call (training,
whose float32 leaves change each step and take the gradient).

Every matrix product is a plain ``einsum``, as ``repro`` computes them
outside any Pallas kernel; the six ``moe/*`` edges go through the
dataplane (``dp``), the dispatch and combine edges in the
``"moe-dispatch"`` QoS class.

One-hot masks are comparisons with an ``arange``, never ``F.one_hot``:
that raises on the -1 of a dropped slot (``jax.nn.one_hot(-1)`` is a
zero row) and reads its input's range back from the card.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.obs import span
from repro_torch.core.tree import tree_flatten
from repro_torch.layers.common import act_fn, constrain, dense_init


EXPERT_LEAVES = ("wi", "wg", "wo")


def _expert(params: dict, leaf: str, dtype: torch.dtype) -> torch.Tensor:
    """Expert leaf ``leaf`` in ``dtype``, in a device-timed ``moe.cast``
    span whose ``held`` says whether the leaf arrived in ``dtype`` already
    (a :func:`held_experts` tree: ``to`` hands it back, nothing is cast).
    Otherwise the leaf is cast here, on every call, right before its
    product, so no cast copy outlives the product that reads it."""
    w = params[leaf]
    with span("moe.cast", device=w.device, leaf=leaf,
              held=w.dtype == dtype):
        return w.to(dtype)


def _expert_leaves(params: dict):
    """``(path, leaf)`` of each expert leaf of every ``moe`` subtree of
    ``params``; arctic's ``dense`` residual is no expert."""
    for path, w in tree_flatten(params):
        if path[-2:-1] == ("moe",) and path[-1] in EXPERT_LEAVES:
            yield path, w


def held_bytes(params: dict, dtype: torch.dtype) -> int:
    """Bytes :func:`held_experts` would allocate for ``params``: its expert
    leaves not in ``dtype`` already, at ``dtype``'s width."""
    return sum(w.numel() * dtype.itemsize
               for _, w in _expert_leaves(params) if w.dtype != dtype)


def held_experts(params: dict, dtype: torch.dtype) -> dict:
    """``params`` with every ``moe`` subtree's expert leaves (``wi``,
    ``wg``, ``wo``, stacked over layers) cast to ``dtype`` once, for a
    caller that serves fixed weights: the layer's slice of a held leaf is
    the bf16 value its per-call cast would make, bit for bit.  Dicts on
    the way to a cast leaf are shallow copies; every other leaf and dict
    is the caller's own, and the caller's tree is never changed.  A leaf
    already in ``dtype`` is not copied, so a tree with nothing to cast is
    returned as it is."""
    out = params
    for path, w in _expert_leaves(params):
        if w.dtype == dtype:
            continue
        if out is params:
            out = dict(params)
        node, src = out, params
        for k in path[:-1]:
            src = src[k]
            if node[k] is src:          # not copied yet
                node[k] = dict(src)
            node = node[k]
        node[path[-1]] = w.to(dtype)
    return out


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig,
             gated: bool = True, device=None) -> dict:
    e = cfg.num_experts

    def experts(in_dim, out_dim):
        # (E, in, out), one expert drawn at a time at fan-in ``in_dim``
        # (repro's dense_init(in, E, out) law): a single expert's draw is
        # the only copy made beside the leaf
        w = torch.empty((e, in_dim, out_dim), device=device)
        for i in range(e):
            w[i] = dense_init(gen, in_dim, out_dim, device=device)
        return w

    p = {"router": dense_init(gen, d_model, e, device=device, scale=1e-2),
         "wi": experts(d_model, d_ff),
         "wo": experts(d_ff, d_model)}
    if gated:
        p["wg"] = experts(d_model, d_ff)
    if cfg.dense_residual:
        from repro_torch.layers.mlp import mlp_init
        p["dense"] = mlp_init(gen, d_model, cfg.dense_residual_ff, gated,
                              device=device)
    return p


def _capacity(group: int, cfg: MoEConfig) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / max(cfg.num_experts, 1))
    return max(c, 1)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a trailing axis of ``n``; -1 gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params: dict, x2d: torch.Tensor, cfg: MoEConfig, *, train: bool,
          rng: torch.Generator | None = None):
    """Router: top-k gates and the aux loss.  x2d: (T, D) flat tokens.
    Returns (gates (T, k) f32, idx (T, k) int64, aux f32 scalar)."""
    logits = torch.matmul(x2d.float(), params["router"].float())
    if train and cfg.router_jitter > 0 and rng is not None:
        logits = logits + cfg.router_jitter * torch.randn(
            logits.shape, generator=rng, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, ties to the lower index (a stable sort)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # aux losses (Switch-style)
    me = probs.mean(dim=0)                                       # (E,)
    ce = _one_hot(idx[:, 0], cfg.num_experts, torch.float32).sum(0) \
        / idx.shape[0]
    lb_loss = cfg.num_experts * torch.sum(me * ce) * cfg.load_balance_loss
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) \
        * cfg.router_z_loss
    return gates, idx, lb_loss + z_loss


def moe(params: dict, x: torch.Tensor, cfg: MoEConfig, *, act: str = "silu",
        group_size: int = 512, train: bool = False,
        rng: torch.Generator | None = None, dp=None):
    """Apply the MoE layer. x: (B, S, D). Returns (out, aux_loss)."""
    b, s, d = x.shape
    tokens = b * s
    # dropless inference over blocks of at most 64 tokens (see the module
    # docstring); training keeps fixed capacity
    g_sz = min(group_size if train else min(group_size, 64), tokens)
    while tokens % g_sz:
        g_sz -= 1
    g = tokens // g_sz
    e, k = cfg.num_experts, cfg.top_k
    c = _capacity(g_sz, cfg) if train else g_sz * k

    xf = x.reshape(tokens, d)
    gates, idx, aux = route(params, xf, cfg, train=train, rng=rng)

    # block-local positions in each expert queue
    onehot = _one_hot(idx.reshape(g, g_sz, k), e, torch.int32)   # (G,n,k,E)
    pos = torch.cumsum(onehot.reshape(g, g_sz * k, e), dim=1) - 1
    pos = pos.reshape(g, g_sz, k, e)
    keep = (pos < c) & (onehot > 0)
    slot = _one_hot(torch.where(keep, pos, -1), c, x.dtype)     # (G,n,k,E,C)
    dispatch = slot.sum(2)                                       # (G,n,E,C)

    xg = xf.reshape(g, g_sz, d)
    xg = constrain(dp, xg, ("exp_groups", None, "embed"), tag="moe/tokens")
    dispatch = constrain(dp, dispatch, ("exp_groups", None, "experts", None),
                         tag="moe/dispatch", qos="moe-dispatch")
    ein = torch.einsum("gnec,gnd->gecd", dispatch, xg)
    ein = constrain(dp, ein, ("exp_groups", "experts", None, "embed"),
                    tag="moe/expert_in", qos="moe-dispatch")

    h = torch.einsum("gecd,edf->gecf", ein, _expert(params, "wi", x.dtype))
    if "wg" in params:
        gate = act_fn(act)(torch.einsum("gecd,edf->gecf", ein,
                                        _expert(params, "wg", x.dtype)))
        # the product in place of the activation where autograd keeps
        # neither (serving): one (G, E, C, F) buffer less at the layer's
        # peak, the same products
        h = gate * h if gate.requires_grad or h.requires_grad \
            else gate.mul_(h)
    else:
        h = act_fn(act)(h)
    # the expert products are batched over E, so with more than one group
    # einsum hands back (G, E, C, ·) as a permuted view; an edge's payload
    # is contiguous (the dataplane kernel copies flat bytes)
    h = constrain(dp, h.contiguous(),
                  ("exp_groups", "experts", None, "expert_mlp"),
                  tag="moe/hidden")
    eo = torch.einsum("gecf,efd->gecd", h, _expert(params, "wo", x.dtype))
    eo = constrain(dp, eo.contiguous(),
                   ("exp_groups", "experts", None, "embed"),
                   tag="moe/expert_out")

    # combine: repro's einsum("gnec,gecd->gnd", gmat, eo) with gmat the
    # gates (rounded to x's dtype) on each token's slots.  Each token's k
    # expert outputs are gathered first (one nonzero term a sum: exact),
    # then weighted and summed over k in float32 and rounded once, so a
    # token's output does not depend on the reduction length E·C, which
    # changes with the grouping; the products of two bf16 values are
    # exact in float32, as in an einsum that accumulates in float32
    picked = torch.einsum("gnkec,gecd->gnkd", slot, eo)
    w = gates.reshape(g, g_sz, k, 1).to(x.dtype).float()
    out = (w * picked.float()).sum(2).to(x.dtype).reshape(b, s, d)
    out = constrain(dp, out, ("batch", "seq", "embed"), tag="moe/out",
                    qos="moe-dispatch")

    if "dense" in params:  # arctic dense residual
        from repro_torch.layers.mlp import mlp as dense_mlp
        out = out + dense_mlp(params["dense"], x, act=act, dp=dp,
                              tag="moe/dense_residual")
    return out, aux


__all__ = ["moe_init", "moe", "route", "held_experts", "held_bytes"]
