"""Unified model interface.

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
have the same signatures as ``repro``'s, bound to one device, so the
serving engine is architecture-agnostic.  This slice serves the dense
family; the others arrive later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    # fixed-shape decode over persistent slots (per-slot positions)
    decode_step_slots: Callable | None = None
    # chunked prefill arrives with a later slice: the engine prefills
    # whole prompts while this is None (JAX holds chunked ≡ whole)
    prefill_chunk: Callable | None = None


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default ``cuda``).  ``init``
    takes a seed or a ``torch.Generator``."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is ported in a later slice; this "
            f"slice serves the dense family")
    m = transformer

    def init(seed):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return m.transformer_init(gen, cfg, device=dev)

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        init_cache=lambda batch, max_len: m.transformer_init_cache(
            cfg, batch, max_len, device=dev),
        prefill=lambda params, batch, cache, **kw: m.transformer_prefill(
            params, cfg, batch, cache, **kw),
        decode_step=lambda params, token, cache, pos, **kw:
            m.transformer_decode_step(params, cfg, token, cache, pos, **kw),
        decode_step_slots=lambda params, token, cache, pos, **kw:
            m.transformer_decode_step_slots(params, cfg, token, cache, pos,
                                            **kw),
    )


__all__ = ["Model", "build_model"]
