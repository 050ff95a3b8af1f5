"""Hymba-style hybrid LM: every block runs attention heads and a mamba
SSM in parallel on the same (normed) input, combining the two branch
outputs (each RMS-normed) by averaging.  Sliding-window attention on all
but the first / middle / last layers (:func:`layer_flags`).

As in ``models/transformer.py``, per-layer weights are stacked on a
leading layer axis, a Python loop over layers takes the place of
``lax.scan``, and every edge goes through the CoRD dataplane (``dp``).
Prefill and the training forward attend through the flash kernel and
run the mamba branch through the SSM scan kernel; with gradients wanted
these are their autograd functions (``layers/attention.FlashAttention``,
``kernels/ssm_scan/ops.SSMScan``).  The cache ``{"k", "v", "conv",
"h"}`` is updated in place.
"""

from __future__ import annotations

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
from repro_torch.layers.mamba import mamba, mamba_init, mamba_state_init
from repro_torch.layers.mlp import mlp, mlp_init
from repro_torch.models.losses import ce_metrics, chunked_ce_loss
from repro_torch.models.remat import REMAT_MODES, remat
from repro_torch.models.transformer import (
    _layer_params,
    layer_flags,
    stack_layers,
)


def hybrid_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from ``gen``, in ``repro``'s layout (stacked
    per-layer weights)."""
    a = cfg.attention

    def one_layer():
        return {
            "norm1": rmsnorm_init(cfg.d_model, device=device),
            "norm2": rmsnorm_init(cfg.d_model, device=device),
            "attn": attention_init(gen, cfg.d_model, a.num_heads,
                                   a.num_kv_heads, cfg.head_dim,
                                   device=device),
            "attn_norm": rmsnorm_init(cfg.d_model, device=device),
            "mamba": mamba_init(gen, cfg.d_model, cfg.ssm, device=device),
            "mamba_norm": rmsnorm_init(cfg.d_model, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                            device=device),
        }

    layers = stack_layers(cfg.num_layers, one_layer)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                tied=cfg.tie_embeddings, device=device),
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }


def _block(lp, x, *, cfg, dp, positions, window, theta, mode, cache,
           cache_pos=None, impl="flash"):
    """One layer over ``cache`` (this layer's ``{"k", "v", "conv", "h"}``
    views, written in place; None in the training forward)."""
    a = cfg.attention
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)

    # --- attention branch ---
    q, k, v = qkv_project(lp["attn"], h, num_kv_heads=a.num_kv_heads,
                          positions=positions, theta=theta, qk_norm=False,
                          eps=cfg.norm_eps, dp=dp)
    if mode in ("train", "prefill"):
        if mode == "prefill":
            kv_update(cache["k"], cache["v"], k, v, 0)
        o = attend(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                   window=window, impl=impl)
    elif mode == "decode_slots":
        # one query per slot at per-slot positions (B,); the mamba branch
        # is per-row recurrent already, so only the mask differs from gang
        ck, cv = cache["k"], cache["v"]
        kv_update_slots(ck, cv, k, v, cache_pos)
        s_max = ck.shape[1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        valid = slot_validity(s_max, cache_pos)               # (B, S_max)
        if window:
            valid &= cache_pos[:, None] - k_pos[None, :] < int(window)
        o = attend_naive(q, ck, cv, valid[:, None, :])
    elif mode == "decode":
        # one query at a position shared by the batch
        ck, cv = cache["k"], cache["v"]
        kv_update(ck, cv, k, v, cache_pos)
        s_max = ck.shape[1]
        k_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        o = attend(q, ck, cv, q_pos=positions, k_pos=k_pos, causal=True,
                   window=window, k_valid=k_pos <= cache_pos)
    else:
        raise ValueError(f"unknown layer mode {mode!r}")
    attn_out = output_project(lp["attn"], o, dp=dp)

    # --- mamba branch (parallel, same input) ---
    st = None if cache is None else {"conv": cache["conv"], "h": cache["h"]}
    m_out, m_state = mamba(lp["mamba"], h, cfg.ssm, state=st, dp=dp,
                           impl="plain" if impl == "plain" else "flash")
    if cache is not None:
        cache["conv"].copy_(m_state["conv"])
        cache["h"].copy_(m_state["h"])

    x = x + 0.5 * (rmsnorm(lp["attn_norm"], attn_out, cfg.norm_eps)
                   + rmsnorm(lp["mamba_norm"], m_out, cfg.norm_eps))

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
                  cache=None if cache is None else
                  {name: t[i] for name, t in cache.items()},
                  cache_pos=cache_pos, impl=impl)
        lp = _layer_params(params["layers"], i)
        if remat_mode == "none":
            x = _block(lp, x, **kw)
        else:
            x = remat(remat_mode, dp, _block, lp, x, **kw)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def hybrid_apply(params, cfg: ModelConfig, batch: dict, *, dp=None,
                 cache=None, train=False, remat="none", impl="flash"):
    """Whole-sequence forward from position 0.  With ``cache`` it is the
    prefill and fills the cache in place; without, the training forward
    (``repro``'s ``mode="train"``).  Returns ``repro``'s (final_hiddens,
    aux, cache, 0), ``aux`` a float32 zero.

    ``remat`` (``"none"``, ``"full"``, ``"dots"``) rematerialises each
    layer body as the transformer's does (``models/remat.py``); ``impl``
    picks the attention (``layers/attention.attend``) and, with
    ``"plain"``, the scan's plain version too.  ``train`` is ``repro``'s
    flag, which no layer of this family reads."""
    del train
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype), dp=dp)
    positions = prefill_positions(tokens.shape[1], tokens.device)
    x = _run_layers(params, cfg, x, dp=dp, positions=positions,
                    mode="prefill" if cache is not None else "train",
                    cache=cache, impl=impl, remat_mode=remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache, 0


def hybrid_loss(params, cfg: ModelConfig, batch: dict, *, dp=None, rng=None,
                remat="none", impl="flash"):
    """Mean next-token cross entropy of ``batch`` (tokens, labels; -1
    ignored) and its metrics: ``(loss, metrics)`` as ``repro``'s."""
    x, aux, _, _ = hybrid_apply(params, cfg, batch, dp=dp, train=True,
                                remat=remat, impl=impl)
    table = params["embed"].get("head", params["embed"]["tok"])
    loss, correct, count = chunked_ce_loss(x, table, batch["labels"], dp=dp)
    m = ce_metrics(loss, correct, count, aux)
    return m["loss"], m


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    a = cfg.attention
    kv = kv_cache_init(cfg.num_layers, batch, max_len, a.num_kv_heads,
                       cfg.head_dim, dtype=dtype_of(cfg.dtype), device=device)
    st = mamba_state_init(batch, cfg.d_model, cfg.ssm, torch.float32,
                          device=device)
    L = cfg.num_layers
    return {"k": kv["k"], "v": kv["v"],
            "conv": st["conv"][None].repeat(L, 1, 1, 1),
            "h": st["h"][None].repeat(L, 1, 1, 1)}


def hybrid_prefill(params, cfg: ModelConfig, batch: dict, cache, *, dp=None,
                   impl="flash", last_pos=None):
    """Fill the attention cache and the mamba state with the prompt;
    returns (last-position logits (B, 1, V) float32, cache).

    ``last_pos`` (B,) selects which hidden position feeds the logits.
    Unlike the transformer's, right padding is NOT harmless here: padding
    tokens advance the mamba recurrence, so the serve engine prefills
    recurrent families at exact prompt length (``Model.recurrent``).
    ``impl`` picks the attention and scan as :func:`hybrid_apply`'s."""
    x, _aux, cache, _ = hybrid_apply(params, cfg, batch, dp=dp, cache=cache,
                                     impl=impl)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def hybrid_decode_step(params, cfg: ModelConfig, token, cache, pos: int, *,
                       dp=None):
    """One decode step. token: (B, 1) int; pos: int write position shared
    by the batch.  Updates ``cache`` in place."""
    x = embed(params["embed"], token, dtype_of(cfg.dtype), dp=dp)
    positions = torch.full((1,), int(pos), dtype=torch.int32,
                           device=token.device)
    x = _run_layers(params, cfg, x, dp=dp, positions=positions,
                    mode="decode", cache=cache, cache_pos=int(pos))
    return logits_fn(params["embed"], x, dp=dp), cache


def hybrid_decode_step_slots(params, cfg: ModelConfig, token, cache, pos, *,
                             dp=None):
    """Fixed-shape slot decode: advance every slot one token at its own
    position ``pos`` (B,).  The attention branch masks per slot; the mamba
    branch is per-row recurrent state and needs no mask: a freed slot's
    state evolves harmlessly until ``state_slot_insert`` replaces the
    whole row.  Updates ``cache`` in place."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = embed(params["embed"], token, dtype_of(cfg.dtype), dp=dp)
    x = _run_layers(params, cfg, x, dp=dp, positions=pos[:, None],
                    mode="decode_slots", cache=cache, cache_pos=pos)
    return logits_fn(params["embed"], x, dp=dp), cache


__all__ = ["hybrid_init", "hybrid_apply", "hybrid_loss", "hybrid_init_cache",
           "hybrid_prefill", "hybrid_decode_step", "hybrid_decode_step_slots"]
