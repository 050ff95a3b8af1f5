"""Unified model interface.

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
have the same signatures as ``repro``'s, bound to one device, so the
serving engine and the train step are architecture-agnostic.  The port
serves the dense family (gemma3, granite) and the hybrid family (hymba),
and trains the dense family; the others arrive in later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    # (params, batch, **kw) -> (loss, metrics); dense family only
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    # fixed-shape decode over persistent slots (per-slot positions)
    decode_step_slots: Callable | None = None
    # chunked prefill: write one (B, C) chunk at an offset.  None for
    # families without it (hybrid); the engine then prefills whole prompts
    prefill_chunk: Callable | None = None
    # True for families with recurrent state (mamba): the engine prefills
    # them at exact prompt length, since right padding would advance the
    # recurrence
    recurrent: bool = False


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default ``cuda``).  ``init``
    takes a seed or a ``torch.Generator``."""
    dev = resolve_device(device)
    if cfg.family == "dense":
        m = transformer
        return Model(
            cfg=cfg,
            device=dev,
            init=_init(m.transformer_init, cfg, dev),
            loss=lambda params, batch, **kw: m.transformer_loss(
                params, cfg, batch, **kw),
            init_cache=lambda batch, max_len: m.transformer_init_cache(
                cfg, batch, max_len, device=dev),
            prefill=lambda params, batch, cache, **kw: m.transformer_prefill(
                params, cfg, batch, cache, **kw),
            decode_step=lambda params, token, cache, pos, **kw:
                m.transformer_decode_step(params, cfg, token, cache, pos,
                                          **kw),
            decode_step_slots=lambda params, token, cache, pos, **kw:
                m.transformer_decode_step_slots(params, cfg, token, cache,
                                                pos, **kw),
            prefill_chunk=lambda params, batch, cache, offset, **kw:
                m.transformer_prefill_chunk(params, cfg, batch, cache,
                                            offset, **kw),
        )
    if cfg.family == "hybrid":
        m = hybrid
        return Model(
            cfg=cfg,
            device=dev,
            init=_init(m.hybrid_init, cfg, dev),
            loss=_hybrid_loss,
            init_cache=lambda batch, max_len: m.hybrid_init_cache(
                cfg, batch, max_len, device=dev),
            prefill=lambda params, batch, cache, **kw: m.hybrid_prefill(
                params, cfg, batch, cache, **kw),
            decode_step=lambda params, token, cache, pos, **kw:
                m.hybrid_decode_step(params, cfg, token, cache, pos, **kw),
            decode_step_slots=lambda params, token, cache, pos, **kw:
                m.hybrid_decode_step_slots(params, cfg, token, cache, pos,
                                           **kw),
            recurrent=True,
        )
    raise NotImplementedError(
        f"the {cfg.family!r} family is ported in a later slice; the port "
        f"serves the dense and hybrid families")


def _hybrid_loss(params, batch, **kw):
    raise NotImplementedError("training the hybrid family is ported with a "
                              "later slice (its forward has no training "
                              "mode yet)")


def _init(init_fn, cfg: ModelConfig, dev: torch.device) -> Callable:
    """``init(seed or torch.Generator)`` over ``init_fn(gen, cfg, device)``."""
    def init(seed):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_fn(gen, cfg, device=dev)
    return init


__all__ = ["Model", "build_model"]
