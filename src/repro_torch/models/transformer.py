"""Decoder-only transformer LM, dense family (gemma3-1b/4b, granite).

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
from repro_torch.layers.common import constrain, dtype_of, rmsnorm, rmsnorm_init
from repro_torch.layers.embedding import embed, embedding_init
from repro_torch.layers.embedding import logits as logits_fn
from repro_torch.layers.kvcache import (
    kv_cache_init,
    kv_update,
    kv_update_slots,
    slot_validity,
)
from repro_torch.layers.mlp import mlp, mlp_init
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


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not a dense transformer: "
            f"models/api.py builds the hybrid family with models/hybrid.py, "
            f"and the others are ported in a later slice")


def transformer_init(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    """Random parameters from ``gen``, in ``repro``'s layout (stacked
    per-layer weights)."""
    _check_dense(cfg)
    a = cfg.attention
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "norm1": rmsnorm_init(cfg.d_model, device=device),
            "norm2": rmsnorm_init(cfg.d_model, device=device),
            "attn": attention_init(gen, cfg.d_model, a.num_heads,
                                   a.num_kv_heads, cfg.head_dim,
                                   qk_norm=a.qk_norm, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                            device=device),
        })
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                tied=cfg.tie_embeddings, device=device),
        "layers": _stack(layers),
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _layer_params(params: dict, i: int) -> dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


def _layer(lp, x, *, cfg, dp, positions, window, theta, mode,
           cache_k=None, cache_v=None, cache_pos=None, impl="flash"):
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
                   window=window, logit_cap=a.logit_softcap)
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
    x = x + mlp(lp["mlp"], h, act=cfg.act_fn, dp=dp)
    return constrain(dp, x, ("batch", "seq_resid", "embed"), tag="layer/out")


def _run_layers(params, cfg, x, *, dp, positions, mode, cache,
                cache_pos=None, impl="flash", remat_mode="none"):
    window_arr, theta_arr = layer_flags(cfg)
    for i in range(cfg.num_layers):
        kw = dict(cfg=cfg, dp=dp, positions=positions,
                  window=int(window_arr[i]), theta=float(theta_arr[i]),
                  mode=mode,
                  cache_k=None if cache is None else cache["k"][i],
                  cache_v=None if cache is None else cache["v"][i],
                  cache_pos=cache_pos, impl=impl)
        lp = _layer_params(params["layers"], i)
        if remat_mode == "none":
            x = _layer(lp, x, **kw)
        else:
            x = remat(remat_mode, dp, _layer, lp, x, **kw)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def transformer_apply(params, cfg: ModelConfig, batch: dict, *, dp=None,
                      cache=None, train=False, remat="none", impl="flash"):
    """Whole-sequence forward from position 0.  With ``cache`` it is the
    prefill and fills the cache in place; without, the training forward
    (``repro``'s ``mode="train"``).  Returns (final_hiddens, cache).

    ``remat`` is ``"none"``, ``"full"`` or ``"dots"``: each layer body
    rematerialised as ``repro``'s ``jax.checkpoint`` does it
    (``models/remat.py``).  ``impl`` picks the whole-sequence attention
    (``layers/attention.attend``)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype), dp=dp)
    positions = prefill_positions(s, tokens.device)
    x = _run_layers(params, cfg, x, dp=dp, positions=positions,
                    mode="prefill" if cache is not None else "train",
                    cache=cache, impl=impl, remat_mode=remat)
    return x, cache


def transformer_loss(params, cfg: ModelConfig, batch: dict, *, dp=None,
                     rng=None, remat="none", impl="flash"):
    """Mean next-token cross entropy of ``batch`` (tokens, labels; -1
    ignored) and its metrics: ``(loss, metrics)`` as ``repro``'s."""
    x, _ = transformer_apply(params, cfg, batch, dp=dp, train=True,
                             remat=remat, impl=impl)
    table = params["embed"].get("head", params["embed"]["tok"])
    loss, correct, count = chunked_ce_loss(x, table, batch["labels"], dp=dp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    m = ce_metrics(loss, correct, count, aux)
    return m["loss"], m


def transformer_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                           device=None):
    a = cfg.attention
    return kv_cache_init(cfg.num_layers, batch, max_len, a.num_kv_heads,
                         cfg.head_dim, dtype=dtype_of(cfg.dtype),
                         device=device)


def transformer_prefill(params, cfg: ModelConfig, batch: dict, cache, *,
                        dp=None, last_pos=None):
    """Fill the cache with the prompt (positions from 0); returns
    (last-position logits (B, 1, V) float32, cache).  ``last_pos`` (B,)
    picks each row's last real token when prompts are right-padded."""
    x, cache = transformer_apply(params, cfg, batch, dp=dp, cache=cache)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def transformer_prefill_chunk(params, cfg: ModelConfig, batch: dict, cache,
                              offset, *, dp=None, last_pos=None):
    """One prefill chunk: write ``batch["tokens"]`` (B, C) into the cache
    at position ``offset`` (in place) and attend causally to everything
    filled so far.  Returns (logits (B, 1, V) float32, cache) like
    :func:`transformer_prefill`, the logits at ``last_pos - offset``
    clipped into the chunk; only the chunk holding ``last_pos`` (the last
    real prompt token) gives logits the caller keeps."""
    tokens = batch["tokens"]
    b, c = tokens.shape
    offset = int(offset)
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype), dp=dp)
    positions = offset + torch.arange(c, dtype=torch.int32,
                                      device=tokens.device)
    x = _run_layers(params, cfg, x, dp=dp, positions=positions, mode="chunk",
                    cache=cache, cache_pos=offset)
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
    x = _run_layers(params, cfg, x, dp=dp, positions=positions,
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
    x = _run_layers(params, cfg, x, dp=dp, positions=pos[:, None],
                    mode="decode_slots", cache=cache, cache_pos=pos)
    return logits_fn(params["embed"], x, dp=dp), cache


__all__ = [
    "transformer_init", "transformer_apply", "transformer_loss",
    "transformer_init_cache",
    "transformer_prefill", "transformer_prefill_chunk",
    "transformer_decode_step",
    "transformer_decode_step_slots", "layer_flags",
]
