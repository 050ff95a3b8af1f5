"""Decoder-only transformer LM covering the dense, MoE and VLM families
(gemma3-4b/1b, granite-34b/3-2b, grok-1-314b, arctic-480b,
llava-next-34b).

The moe family takes :func:`~repro_torch.layers.moe.moe` in place of the
MLP, and each layer adds its router's aux loss to the training loss; the
vlm family prepends a projection of precomputed image patches
(``batch["patches"]``, the stub frontend) to the token embeddings, so a
prefill's positions run over prefix plus text.

Per-layer weights are stacked on a leading layer axis as in ``repro``,
and a Python loop over layers takes the place of ``lax.scan``.  Per-layer
heterogeneity (gemma3's 5:1 local:global pattern, per-layer RoPE theta)
comes from :func:`layer_flags`, which ``models/hybrid.py`` shares.  Every
communication edge is issued through the CoRD dataplane (``dp``); with a
mesh and ``emulate_costs`` each edge launches the dataplane kernel on the
card.

Training (:func:`transformer_loss`) runs the whole sequence with no
cache and attends through the flash kernel's autograd function.  The KV
cache is updated in place (``layers/kvcache.py``).  Whole-prompt prefill
attends through the flash kernel; decode and prefill chunks
(:func:`transformer_prefill_chunk`, a chunk at an offset against the
cache filled so far) take the plain masked softmax, as ``repro`` computes
them outside its Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (
    attend,
    attend_naive,
    attention_init,
    output_project,
    prefill_positions,
    qkv_project,
)
from repro_torch.layers.common import (
    constrain,
    dense_init,
    dtype_of,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.layers.embedding import embed, embedding_init
from repro_torch.layers.embedding import logits as logits_fn
from repro_torch.layers.kvcache import (
    kv_cache_init,
    kv_update,
    kv_update_slots,
    slot_validity,
)
from repro_torch.layers.mlp import mlp, mlp_init
from repro_torch.layers.moe import moe, moe_init
from repro_torch.models.losses import ce_metrics, chunked_ce_loss
from repro_torch.models.remat import REMAT_MODES, remat

CACHE_AXES = ("batch", "kv_seq", "kv_heads", "cache_head_dim")


def layer_flags(cfg: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-layer (window, rope theta): window 0 means global."""
    a = cfg.attention
    L = cfg.num_layers
    if a.local_global_ratio > 0 and a.sliding_window > 0:
        r = a.local_global_ratio
        is_global = np.array([(i % (r + 1)) == r for i in range(L)])
    elif cfg.family == "hybrid" and a.sliding_window > 0:
        is_global = np.zeros(L, bool)
        is_global[[0, L // 2, L - 1]] = True
    elif a.sliding_window > 0:
        is_global = np.zeros(L, bool)
    else:
        is_global = np.ones(L, bool)
    theta_g = a.rope_theta_global or a.rope_theta
    theta = np.where(is_global, theta_g, a.rope_theta).astype(np.float32)
    window = np.where(is_global, 0, a.sliding_window).astype(np.int32)
    return window, theta


def transformer_init(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    """Random parameters from ``gen``, in ``repro``'s layout (stacked
    per-layer weights; :func:`stack_layers`)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the {cfg.family!r} family is not a transformer "
                         f"of models/transformer.py")
    a = cfg.attention

    def one_layer():
        p = {
            "norm1": rmsnorm_init(cfg.d_model, device=device),
            "norm2": rmsnorm_init(cfg.d_model, device=device),
            "attn": attention_init(gen, cfg.d_model, a.num_heads,
                                   a.num_kv_heads, cfg.head_dim,
                                   qk_norm=a.qk_norm, device=device),
        }
        if cfg.family == "moe":
            p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe,
                                gated=cfg.gated_mlp, device=device)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff,
                                gated=cfg.gated_mlp, device=device)
        return p

    layers = stack_layers(cfg.num_layers, one_layer)
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                tied=cfg.tie_embeddings, device=device),
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }
    if cfg.family == "vlm":
        params["vision_proj"] = dense_init(gen, cfg.frontend_dim,
                                           cfg.d_model, device=device)
    return params


def stack_layers(n: int, one_layer) -> dict:
    """``n`` draws of ``one_layer()`` stacked on a leading layer axis.
    Each stacked leaf is allocated once and filled layer by layer, so the
    parameters are never held twice (a list of layers then
    ``torch.stack`` would hold them twice)."""
    stacked = None
    for i in range(n):
        lp = one_layer()
        if stacked is None:
            stacked = _stacked_like(lp, n)
        _fill(stacked, lp, i)
        del lp          # before the next layer is drawn
    return stacked


def _stacked_like(tree: dict, n: int) -> dict:
    return {k: (_stacked_like(v, n) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)))
            for k, v in tree.items()}


def _fill(stacked: dict, tree: dict, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def _layer_params(params: dict, i: int) -> dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


def _layer(lp, x, *, cfg, dp, positions, window, theta, mode,
           cache_k=None, cache_v=None, cache_pos=None, impl="flash",
           train=False):
    """One layer; returns (x, aux): the router's aux loss of a moe layer,
    None for the others."""
    a = cfg.attention
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    q, k, v = qkv_project(lp["attn"], h, num_kv_heads=a.num_kv_heads,
                          positions=positions, theta=theta,
                          qk_norm=a.qk_norm, eps=cfg.norm_eps, dp=dp)
    if mode == "train":
        o = attend(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                   window=window, logit_cap=a.logit_softcap, impl=impl)
    elif mode == "prefill":
        kv_update(cache_k, cache_v, k, v, 0)
        o = attend(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                   window=window, logit_cap=a.logit_softcap, impl=impl)
    elif mode == "chunk":
        # a prefill chunk written at offset cache_pos, attending to
        # everything filled so far; the cache edges are the mediation a
        # decode tick pays, so every chunk is accounted like one
        kv_update(cache_k, cache_v, k, v, cache_pos)
        s_max = cache_k.shape[1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        k_valid = k_pos < cache_pos + q.shape[1]
        ck = constrain(dp, cache_k, CACHE_AXES, tag="attn/cache_k")
        cv = constrain(dp, cache_v, CACHE_AXES, tag="attn/cache_v")
        o = attend(q, ck, cv, q_pos=positions, k_pos=k_pos, causal=True,
                   window=window, logit_cap=a.logit_softcap, k_valid=k_valid)
    elif mode == "decode_slots":
        # one query per slot, per-slot write positions (B,)
        kv_update_slots(cache_k, cache_v, k, v, cache_pos)
        s_max = cache_k.shape[1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        ck = constrain(dp, cache_k, CACHE_AXES, tag="attn/cache_k")
        cv = constrain(dp, cache_v, CACHE_AXES, tag="attn/cache_v")
        valid = slot_validity(s_max, cache_pos)               # (B, S_max)
        if window:
            valid &= cache_pos[:, None] - k_pos[None, :] < int(window)
        o = attend_naive(q, ck, cv, valid[:, None, :],
                         logit_cap=a.logit_softcap)
    elif mode == "decode":
        # one query at a shared position against the cache
        kv_update(cache_k, cache_v, k, v, cache_pos)
        s_max = cache_k.shape[1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        k_valid = k_pos <= cache_pos
        ck = constrain(dp, cache_k, CACHE_AXES, tag="attn/cache_k")
        cv = constrain(dp, cache_v, CACHE_AXES, tag="attn/cache_v")
        o = attend(q, ck, cv, q_pos=positions, k_pos=k_pos, causal=True,
                   window=window, logit_cap=a.logit_softcap, k_valid=k_valid)
    else:
        raise ValueError(f"unknown layer mode {mode!r}")
    x = x + output_project(lp["attn"], o, dp=dp)
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    aux = None
    if cfg.family == "moe":
        f, aux = moe(lp["moe"], h, cfg.moe, act=cfg.act_fn, train=train,
                     dp=dp)
    else:
        f = mlp(lp["mlp"], h, act=cfg.act_fn, dp=dp)
    x = x + f
    return constrain(dp, x, ("batch", "seq_resid", "embed"),
                     tag="layer/out"), aux


def _run_layers(params, cfg, x, *, dp, positions, mode, cache,
                cache_pos=None, impl="flash", remat_mode="none",
                train=False):
    """Every layer, then the final norm: (x, aux), the layers' aux losses
    summed in float32 from 0 as ``repro``'s scan carries them (None when
    no layer has one)."""
    window_arr, theta_arr = layer_flags(cfg)
    aux = None
    for i in range(cfg.num_layers):
        kw = dict(cfg=cfg, dp=dp, positions=positions,
                  window=int(window_arr[i]), theta=float(theta_arr[i]),
                  mode=mode,
                  cache_k=None if cache is None else cache["k"][i],
                  cache_v=None if cache is None else cache["v"][i],
                  cache_pos=cache_pos, impl=impl, train=train)
        lp = _layer_params(params["layers"], i)
        if remat_mode == "none":
            x, a = _layer(lp, x, **kw)
        else:
            x, a = remat(remat_mode, dp, _layer, lp, x, **kw)
        if a is not None:
            if aux is None:
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
            aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def transformer_apply(params, cfg: ModelConfig, batch: dict, *, dp=None,
                      cache=None, train=False, remat="none", impl="flash"):
    """Whole-sequence forward from position 0.  With ``cache`` it is the
    prefill and fills the cache in place; without, the training forward
    (``repro``'s ``mode="train"``).  A vlm batch with ``"patches"`` (B, P,
    frontend_dim) gets their projection prepended to the token embeddings
    (its ``vision/proj`` edge after the embedding's), and the positions
    run over prefix plus text.  Returns ``repro``'s (final_hiddens, aux,
    cache, prefix_len): ``aux`` the moe layers' summed aux loss (a float32
    zero for the other families).

    ``train`` picks the moe layers' fixed-capacity dispatch (dropless
    otherwise).  ``remat`` is ``"none"``, ``"full"`` or ``"dots"``: each
    layer body rematerialised as ``repro``'s ``jax.checkpoint`` does it
    (``models/remat.py``).  ``impl`` picks the whole-sequence attention
    (``layers/attention.attend``)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    dtype = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype, dp=dp)
    prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        pe = torch.matmul(batch["patches"].to(dtype),
                          params["vision_proj"].to(dtype))
        pe = constrain(dp, pe, ("batch", "seq", "embed"), tag="vision/proj")
        x = torch.cat([pe, x], dim=1)
        prefix = pe.shape[1]
        s = s + prefix
    positions = prefill_positions(s, tokens.device)
    x, aux = _run_layers(params, cfg, x, dp=dp, positions=positions,
                         mode="prefill" if cache is not None else "train",
                         cache=cache, impl=impl, remat_mode=remat,
                         train=train)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache, prefix


def transformer_loss(params, cfg: ModelConfig, batch: dict, *, dp=None,
                     rng=None, remat="none", impl="flash"):
    """Mean next-token cross entropy of ``batch`` (tokens, labels; -1
    ignored) plus the moe layers' aux loss, and its metrics: ``(loss,
    metrics)`` as ``repro``'s.  A vlm prefix is sliced off before the
    cross entropy."""
    x, aux, _, prefix = transformer_apply(params, cfg, batch, dp=dp,
                                          train=True, remat=remat, impl=impl)
    if prefix:
        x = x[:, prefix:]
    table = params["embed"].get("head", params["embed"]["tok"])
    loss, correct, count = chunked_ce_loss(x, table, batch["labels"], dp=dp)
    m = ce_metrics(loss, correct, count, aux)
    return m["loss"], m


def transformer_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                           device=None):
    a = cfg.attention
    return kv_cache_init(cfg.num_layers, batch, max_len, a.num_kv_heads,
                         cfg.head_dim, dtype=dtype_of(cfg.dtype),
                         device=device)


def transformer_prefill(params, cfg: ModelConfig, batch: dict, cache, *,
                        dp=None, impl="flash", last_pos=None):
    """Fill the cache with the prompt (positions from 0, a vlm prefix
    first); returns (last-position logits (B, 1, V) float32, cache).
    ``last_pos`` (B,) picks each row's last real token when prompts are
    right-padded, counted in text tokens (the prefix is added here).
    ``impl`` picks the attention as :func:`transformer_apply`'s."""
    x, _aux, cache, prefix = transformer_apply(params, cfg, batch, dp=dp,
                                               cache=cache, impl=impl)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        idx = idx + prefix
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def transformer_prefill_chunk(params, cfg: ModelConfig, batch: dict, cache,
                              offset, *, dp=None, last_pos=None):
    """One prefill chunk: write ``batch["tokens"]`` (B, C) into the cache
    at position ``offset`` (in place) and attend causally to everything
    filled so far.  Returns (logits (B, 1, V) float32, cache) like
    :func:`transformer_prefill`, the logits at ``last_pos - offset``
    clipped into the chunk; only the chunk holding ``last_pos`` (the last
    real prompt token) gives logits the caller keeps.  Chunks are
    token-only (a vlm prefix is prefilled whole), as in ``repro``."""
    tokens = batch["tokens"]
    b, c = tokens.shape
    offset = int(offset)
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype), dp=dp)
    positions = offset + torch.arange(c, dtype=torch.int32,
                                      device=tokens.device)
    x, _aux = _run_layers(params, cfg, x, dp=dp, positions=positions,
                          mode="chunk", cache=cache, cache_pos=offset)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        idx = (idx - offset).clamp(0, c - 1)
        last = x[torch.arange(b, device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def transformer_decode_step(params, cfg: ModelConfig, token, cache, pos: int,
                            *, dp=None):
    """One decode step. token: (B, 1) int; pos: int write position shared
    by the batch.  Updates ``cache`` in place."""
    x = embed(params["embed"], token, dtype_of(cfg.dtype), dp=dp)
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=token.device)
    x, _aux = _run_layers(params, cfg, x, dp=dp, positions=positions,
                          mode="decode", cache=cache, cache_pos=int(pos))
    return logits_fn(params["embed"], x, dp=dp), cache


def transformer_decode_step_slots(params, cfg: ModelConfig, token, cache,
                                  pos, *, dp=None):
    """One fixed-shape decode step over persistent slots.  token: (B, 1);
    pos: (B,) per-slot write positions.  Free slots still compute; their
    writes land at a stale position that the validity mask hides.
    Updates ``cache`` in place."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = embed(params["embed"], token, dtype_of(cfg.dtype), dp=dp)
    x, _aux = _run_layers(params, cfg, x, dp=dp, positions=pos[:, None],
                          mode="decode_slots", cache=cache, cache_pos=pos)
    return logits_fn(params["embed"], x, dp=dp), cache


__all__ = [
    "transformer_init", "transformer_apply", "transformer_loss",
    "transformer_init_cache",
    "transformer_prefill", "transformer_prefill_chunk",
    "transformer_decode_step",
    "transformer_decode_step_slots", "layer_flags", "stack_layers",
]
