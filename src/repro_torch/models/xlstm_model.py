"""xLSTM LM (xlstm-350m): a stack of mLSTM and sLSTM blocks following the
configured block pattern (e.g. "mmms" = 3 mLSTM : 1 sLSTM), in *pattern
units*: each block of the unit is stacked on a leading repeat axis in
``repro``'s layout (``units/blk{j}``), and a Python loop over the repeats
takes the place of ``lax.scan``.  The ``layer/out`` edge is crossed once
a unit, as ``repro``'s scan body crosses it.  Decode is pure recurrent
state: O(1) memory per token.  The cache (``{"blk{j}": state}``, each
leaf (reps, B, ...)) is updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import (
    constrain,
    dtype_of,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.layers.embedding import embed, embedding_init
from repro_torch.layers.embedding import logits as logits_fn
from repro_torch.layers.xlstm import (
    mlstm,
    mlstm_init,
    mlstm_state_init,
    slstm,
    slstm_init,
    slstm_state_init,
)
from repro_torch.models.losses import ce_metrics, chunked_ce_loss
from repro_torch.models.remat import REMAT_MODES, remat
from repro_torch.models.transformer import _layer_params, stack_layers


def _pattern(cfg: ModelConfig) -> str:
    pat = cfg.ssm.block_pattern
    L = cfg.num_layers
    if L % len(pat):
        # cycle the pattern and cut: fall back to unit = full depth
        pat = (pat * L)[:L]
    return pat


def xlstm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from ``gen``, in ``repro``'s layout."""
    pat = _pattern(cfg)
    reps = cfg.num_layers // len(pat)
    embed_p = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                             tied=cfg.tie_embeddings, device=device)
    units = {}
    for j, kind in enumerate(pat):
        init = mlstm_init if kind == "m" else slstm_init

        def one(init=init):
            return {"norm": rmsnorm_init(cfg.d_model, device=device),
                    "core": init(gen, cfg.d_model, cfg.ssm, device=device)}
        units[f"blk{j}"] = stack_layers(reps, one)
    return {"embed": embed_p, "units": units,
            "final_norm": rmsnorm_init(cfg.d_model, device=device)}


def _unit_states(cfg: ModelConfig, batch: int, device=None) -> dict:
    pat = _pattern(cfg)
    reps = cfg.num_layers // len(pat)
    states = {}
    for j, kind in enumerate(pat):
        init = mlstm_state_init if kind == "m" else slstm_state_init
        st = init(batch, cfg.d_model, cfg.ssm, device=device)
        states[f"blk{j}"] = {k: v[None].repeat((reps,) + (1,) * v.dim())
                             for k, v in st.items()}
    return states


def _unit(ups, x, *, cfg, dp, states, chunk, decode=False):
    """One pattern unit: each block's norm, core and residual, then the
    ``layer/out`` edge (none in decode, as in ``repro``).  ``states`` (the
    unit's block states, None in training) are written in place."""
    for j, kind in enumerate(_pattern(cfg)):
        blk = ups[f"blk{j}"]
        st = None if states is None else states[f"blk{j}"]
        h = rmsnorm(blk["norm"], x, cfg.norm_eps)
        if kind == "m":
            out, ns = mlstm(blk["core"], h, cfg.ssm, state=st, dp=dp,
                            chunk=chunk)
        else:
            out, ns = slstm(blk["core"], h, cfg.ssm, state=st, dp=dp)
        x = x + out
        if st is not None:
            for name, t in st.items():
                t.copy_(ns[name])
    if decode:
        return x
    return constrain(dp, x, ("batch", "seq_resid", "embed"), tag="layer/out")


def _run_units(params, cfg, x, *, dp, cache, chunk, remat_mode="none",
               decode=False):
    reps = cfg.num_layers // len(_pattern(cfg))
    for i in range(reps):
        ups = _layer_params(params["units"], i)
        states = None if cache is None else _layer_params(cache, i)
        kw = dict(cfg=cfg, dp=dp, states=states, chunk=chunk, decode=decode)
        if remat_mode == "none":
            x = _unit(ups, x, **kw)
        else:
            x = remat(remat_mode, dp, _unit, ups, x, **kw)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def xlstm_apply(params, cfg: ModelConfig, batch: dict, *, dp=None,
                cache=None, train=False, remat="none", chunk: int = 128):
    """Whole-sequence forward from the cache's state (prefill, written in
    place) or from zero state (training, ``cache=None``).  Returns
    ``repro``'s (final_hiddens, aux, cache, 0), ``aux`` a float32 zero.
    ``remat`` as the transformer's, one unit at a time."""
    del train
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    x = embed(params["embed"], batch["tokens"], dtype_of(cfg.dtype), dp=dp)
    x = _run_units(params, cfg, x, dp=dp, cache=cache, chunk=chunk,
                   remat_mode=remat)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        cache, 0


def xlstm_loss(params, cfg: ModelConfig, batch: dict, *, dp=None, rng=None,
               remat="none", impl="flash"):
    """Mean next-token cross entropy and its metrics, as ``repro``'s
    (``impl`` is taken and unused: the family has no attention)."""
    x, aux, _, _ = xlstm_apply(params, cfg, batch, dp=dp, train=True,
                               remat=remat)
    table = params["embed"].get("head", params["embed"]["tok"])
    loss, correct, count = chunked_ce_loss(x, table, batch["labels"], dp=dp)
    m = ce_metrics(loss, correct, count, aux)
    return m["loss"], m


def xlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                     device=None) -> dict:
    return _unit_states(cfg, batch, device=device)


def xlstm_prefill(params, cfg: ModelConfig, batch: dict, cache, *, dp=None,
                  impl="flash", last_pos=None):
    """Run the prompt through the recurrence, returning (logits (B, 1, V)
    float32, cache).

    ``last_pos`` (B,) selects the hidden position feeding the logits.
    Padding is NOT inert for a recurrence (every token, real or pad,
    advances the mLSTM/sLSTM memories), so the serve engine prefills this
    family at exact prompt length (``Model.recurrent``)."""
    x, _aux, cache, _ = xlstm_apply(params, cfg, batch, dp=dp, cache=cache)
    if last_pos is None:
        last = x[:, -1:, :]
    else:
        idx = torch.as_tensor(last_pos, dtype=torch.long, device=x.device)
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return logits_fn(params["embed"], last, dp=dp), cache


def xlstm_decode_step(params, cfg: ModelConfig, token, cache, pos, *,
                      dp=None, **_):
    """One decode step: every block at S = 1 (mLSTM with one chunk of one
    step).  Updates ``cache`` in place; ``pos`` is unused (the state
    carries the position)."""
    x = embed(params["embed"], token, dtype_of(cfg.dtype), dp=dp)
    x = _run_units(params, cfg, x, dp=dp, cache=cache, chunk=1, decode=True)
    return logits_fn(params["embed"], x, dp=dp), cache


def xlstm_decode_step_slots(params, cfg: ModelConfig, token, cache, pos, *,
                            dp=None, **_):
    """Fixed-shape slot decode for the pure-recurrent family: decode is
    position-free and every batch row advances on its own, so the gang
    decode step is the slot decode step and ``pos`` is unused.  A freed
    slot's state evolves on stale tokens until ``state_slot_insert``
    overwrites its whole row."""
    del pos
    return xlstm_decode_step(params, cfg, token, cache, 0, dp=dp)


__all__ = ["xlstm_init", "xlstm_apply", "xlstm_loss", "xlstm_init_cache",
           "xlstm_prefill", "xlstm_decode_step", "xlstm_decode_step_slots"]
