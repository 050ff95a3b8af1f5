"""Whisper-style encoder-decoder backbone.

The conv/mel frontend is a stub: ``input_specs`` provides precomputed
frame features (B, T_enc, n_mels), which a linear projection lifts to
d_model.  Encoder layers attend bidirectionally; decoder layers run
causal self-attention, then cross-attention over the encoder's output.
Positions are sinusoidal (no RoPE).

As in ``models/transformer.py``, per-layer weights are stacked on a
leading layer axis and a Python loop over layers takes the place of
``lax.scan``.  The encoder, the decoder's self-attention and its
cross-attention at prefill and in training take the flash kernel (the
encoder and the cross-attention non-causal, the latter with Sq != Skv);
decode attends in plain torch, its cross-attention over every encoder
position.  The cache ``{"k", "v", "cross_k", "cross_v"}`` is updated in
place; prefill snapshots the encoder's projected k/v into ``cross_k`` /
``cross_v``.
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
from repro_torch.layers.rope import sinusoidal_positions
from repro_torch.models.losses import ce_metrics, chunked_ce_loss
from repro_torch.models.remat import REMAT_MODES, remat
from repro_torch.models.transformer import _layer_params, stack_layers


def encdec_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from ``gen``, in ``repro``'s layout."""
    a = cfg.attention

    def attn():
        return attention_init(gen, cfg.d_model, a.num_heads, a.num_kv_heads,
                              cfg.head_dim, device=device)

    def enc_layer():
        return {"norm1": rmsnorm_init(cfg.d_model, device=device),
                "attn": attn(),
                "norm2": rmsnorm_init(cfg.d_model, device=device),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                                device=device)}

    def dec_layer():
        return {"norm1": rmsnorm_init(cfg.d_model, device=device),
                "self_attn": attn(),
                "norm_x": rmsnorm_init(cfg.d_model, device=device),
                "cross_attn": attn(),
                "norm2": rmsnorm_init(cfg.d_model, device=device),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                                device=device)}

    return {
        "frontend": dense_init(gen, cfg.frontend_dim, cfg.d_model,
                               device=device),
        "enc_layers": stack_layers(cfg.encoder_layers, enc_layer),
        "enc_norm": rmsnorm_init(cfg.d_model, device=device),
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                tied=cfg.tie_embeddings, device=device),
        "layers": stack_layers(cfg.num_layers, dec_layer),
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *, dp=None,
           impl="flash"):
    """frames: (B, T, n_mels) -> (B, T, D)."""
    dtype = dtype_of(cfg.dtype)
    a = cfg.attention
    x = torch.einsum("btf,fd->btd", frames.to(dtype),
                     params["frontend"].to(dtype))
    t = x.shape[1]
    x = x + sinusoidal_positions(t, cfg.d_model, dtype, device=x.device)
    x = constrain(dp, x, ("batch", "seq", "embed"), tag="enc/in")
    positions = prefill_positions(t, x.device)
    for i in range(cfg.encoder_layers):
        lp = _layer_params(params["enc_layers"], i)
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = qkv_project(lp["attn"], h, num_kv_heads=a.num_kv_heads,
                              positions=positions, theta=None,
                              qk_norm=False, eps=cfg.norm_eps, dp=dp)
        o = attend(q, k, v, q_pos=positions, k_pos=positions, causal=False,
                   window=None, impl=impl)
        x = x + output_project(lp["attn"], o, dp=dp)
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, act=cfg.act_fn, dp=dp)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, x, enc, *, cfg, dp, positions, enc_positions, mode,
               cache=None, cache_pos=None, impl="flash"):
    """One decoder layer over ``cache`` (this layer's ``{"k", "v",
    "cross_k", "cross_v"}`` views, written in place; None in training)."""
    a = cfg.attention
    # self attention
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    q, k, v = qkv_project(lp["self_attn"], h, num_kv_heads=a.num_kv_heads,
                          positions=positions, theta=None, qk_norm=False,
                          eps=cfg.norm_eps, dp=dp)
    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        kv_update(ck, cv, k, v, cache_pos)
        k_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=x.device)
        o = attend(q, ck, cv, q_pos=positions, k_pos=k_pos, causal=True,
                   window=None, k_valid=k_pos <= cache_pos)
    elif mode == "decode_slots":
        # per-slot write positions (B,), batched validity mask; the
        # cross-attention cache below is a per-slot snapshot of the
        # encoder's k/v, inserted whole and never advanced
        ck, cv = cache["k"], cache["v"]
        kv_update_slots(ck, cv, k, v, cache_pos)
        valid = slot_validity(ck.shape[1], cache_pos)           # (B, S_max)
        o = attend_naive(q, ck, cv, valid[:, None, :])
    elif mode in ("prefill", "train"):
        if cache is not None:
            kv_update(cache["k"], cache["v"], k, v, 0)
        o = attend(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                   window=None, impl=impl)
    else:
        raise ValueError(f"unknown layer mode {mode!r}")
    x = x + output_project(lp["self_attn"], o, dp=dp)

    # cross attention
    h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
    if mode in ("decode", "decode_slots"):
        qc = torch.einsum("bsd,dhe->bshe", h,
                          lp["cross_attn"]["wq"].to(h.dtype))
        kc, vc = cache["cross_k"], cache["cross_v"]
        # every encoder position is valid for every query: the all-true
        # mask is the unmasked non-causal attention
        every = torch.ones((1, 1, kc.shape[1]), dtype=torch.bool,
                           device=x.device)
        o = attend_naive(qc, kc, vc, every)
    else:
        qc, kc, vc = qkv_project(lp["cross_attn"], h,
                                 num_kv_heads=a.num_kv_heads,
                                 positions=positions, theta=None,
                                 qk_norm=False, eps=cfg.norm_eps, dp=dp,
                                 kv_input=enc)
        if cache is not None:
            cache["cross_k"].copy_(kc)
            cache["cross_v"].copy_(vc)
        o = attend(qc, kc, vc, q_pos=positions, k_pos=enc_positions,
                   causal=False, window=None, impl=impl)
    x = x + output_project(lp["cross_attn"], o, dp=dp)

    # mlp
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    x = x + mlp(lp["mlp"], h, act=cfg.act_fn, dp=dp)
    return constrain(dp, x, ("batch", "seq_resid", "embed"), tag="layer/out")


def _run_layers(params, cfg, x, enc, *, dp, positions, enc_positions, mode,
                cache, cache_pos=None, impl="flash", remat_mode="none"):
    for i in range(cfg.num_layers):
        kw = dict(cfg=cfg, dp=dp, positions=positions,
                  enc_positions=enc_positions, mode=mode,
                  cache=None if cache is None else
                  {name: t[i] for name, t in cache.items()},
                  cache_pos=cache_pos, impl=impl)
        lp = _layer_params(params["layers"], i)
        if remat_mode == "none":
            x = _dec_layer(lp, x, enc, **kw)
        else:
            x = remat(remat_mode, dp, _dec_layer, lp, x, enc, **kw)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def encdec_apply(params, cfg: ModelConfig, batch: dict, *, dp=None,
                 cache=None, train=False, remat="none", impl="flash"):
    """Encode ``batch["frames"]``, then run the decoder over
    ``batch["tokens"]`` from position 0: the prefill with ``cache``
    (filled in place, the cross-attention snapshot included), the
    training forward without.  Returns ``repro``'s (final_hiddens, aux,
    cache, 0), ``aux`` a float32 zero.  ``remat`` rematerialises each
    decoder layer as ``repro``'s does (the encoder is not); ``impl``
    picks the whole-sequence attention (``layers/attention.attend``)."""
    del train
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    dtype = dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    enc = encode(params, cfg, batch["frames"], dp=dp, impl=impl)
    enc_positions = prefill_positions(enc.shape[1], enc.device)
    x = embed(params["embed"], tokens, dtype, scale=False, dp=dp)
    x = x + sinusoidal_positions(s, cfg.d_model, dtype, device=x.device)
    positions = prefill_positions(s, tokens.device)
    x = _run_layers(params, cfg, x, enc, dp=dp, positions=positions,
                    enc_positions=enc_positions,
                    mode="prefill" if cache is not None else "train",
                    cache=cache, impl=impl, remat_mode=remat)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        cache, 0


def encdec_loss(params, cfg: ModelConfig, batch: dict, *, dp=None, rng=None,
                remat="none", impl="flash"):
    """Mean next-token cross entropy of the decoder and its metrics, as
    ``repro``'s."""
    x, aux, _, _ = encdec_apply(params, cfg, batch, dp=dp, train=True,
                                remat=remat, impl=impl)
    table = params["embed"].get("head", params["embed"]["tok"])
    loss, correct, count = chunked_ce_loss(x, table, batch["labels"], dp=dp)
    m = ce_metrics(loss, correct, count, aux)
    return m["loss"], m


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    a = cfg.attention
    dtype = dtype_of(cfg.dtype)
    kv = kv_cache_init(cfg.num_layers, batch, max_len, a.num_kv_heads,
                       cfg.head_dim, dtype=dtype, device=device)
    # the cross k/v are filled at prefill (encoder length)
    shape = (cfg.num_layers, batch, cfg.encoder_max_len, a.num_kv_heads,
             cfg.head_dim)
    kv["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
    kv["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return kv


def encdec_prefill(params, cfg: ModelConfig, batch: dict, cache, *, dp=None,
                   impl="flash", last_pos=None):
    """Decoder prefill: fills the self-attention cache and snapshots the
    encoder's projected k/v into the per-slot cross_k / cross_v cache;
    returns (logits (B, 1, V) float32, cache).

    The serve engine submits token-only batches; the frontend is a stub,
    so without ``frames`` a zero frame window of the configured encoder
    geometry stands in (the same for gang and continuous serving).
    ``last_pos`` (B,) picks the hidden position whose logits are returned
    (right padding after the prompt is causally inert for the decoder)."""
    if "frames" not in batch:
        b = batch["tokens"].shape[0]
        batch = dict(batch, frames=torch.zeros(
            (b, cfg.encoder_max_len, cfg.frontend_dim), dtype=torch.float32,
            device=batch["tokens"].device))
    x, _aux, cache, _ = encdec_apply(params, cfg, batch, dp=dp, cache=cache,
                                     impl=impl)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def _decode(params, cfg, cache, x, *, dp, positions, mode, cache_pos):
    """The decoder layers at one token a row; the cross-attention reads
    the cache's encoder snapshot, so there is no encoder output."""
    x = _run_layers(params, cfg, x, None, dp=dp, positions=positions,
                    enc_positions=None, mode=mode, cache=cache,
                    cache_pos=cache_pos)
    return logits_fn(params["embed"], x, dp=dp), cache


def encdec_decode_step(params, cfg: ModelConfig, token, cache, pos: int, *,
                       dp=None, **_):
    """One decode step. token: (B, 1) int; pos: int write position shared
    by the batch.  Updates ``cache`` in place."""
    dtype = dtype_of(cfg.dtype)
    pos = int(pos)
    x = embed(params["embed"], token, dtype, scale=False, dp=dp)
    tbl = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, dtype,
                               device=x.device)
    x = x + tbl[pos:pos + 1][None]
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    return _decode(params, cfg, cache, x, dp=dp, positions=positions,
                   mode="decode", cache_pos=pos)


def encdec_decode_step_slots(params, cfg: ModelConfig, token, cache, pos, *,
                             dp=None, **_):
    """Fixed-shape slot decode: every slot advances one token at its own
    position ``pos`` (B,), its sinusoidal position gathered per slot; the
    self-attention masks per slot, the cross-attention reads each slot's
    whole encoder snapshot.  Updates ``cache`` in place."""
    dtype = dtype_of(cfg.dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = embed(params["embed"], token, dtype, scale=False, dp=dp)
    tbl = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, dtype,
                               device=x.device)
    x = x + tbl[pos.long()][:, None, :]                       # (B, 1, D)
    return _decode(params, cfg, cache, x, dp=dp, positions=pos[:, None],
                   mode="decode_slots", cache_pos=pos)


__all__ = ["encdec_init", "encdec_apply", "encdec_loss", "encdec_init_cache",
           "encdec_prefill", "encdec_decode_step", "encdec_decode_step_slots",
           "encode"]
