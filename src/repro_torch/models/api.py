"""Unified model interface and input specs.

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
have the same signatures as ``repro``'s, bound to one device, so the
serving engine and the train step are architecture-agnostic.  The port
serves and trains every family ``repro`` builds: the transformer
families (dense: gemma3, granite; moe: grok-1, arctic; vlm: llava-next),
the hybrid family (hymba), the ssm family (xlstm) and the encdec family
(whisper).

``input_specs(cfg, shape)`` returns ``(shape, dtype)`` stand-ins for
every model input of a shape cell, with no allocation, and
``make_batch`` a random batch that matches them.  The modality frontend
is a stub: vlm cells get precomputed patch embeddings, audio cells
precomputed mel frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer, xlstm_model


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    # (params, batch, **kw) -> (loss, metrics)
    loss: Callable
    # (params, batch, **kw) -> the whole-sequence forward: (hiddens, aux,
    # cache, prefix) as repro's, for every family
    apply: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    # fixed-shape decode over persistent slots (per-slot positions)
    decode_step_slots: Callable | None = None
    # chunked prefill: write one (B, C) chunk at an offset.  None for
    # families without it (hybrid, ssm, encdec); the engine then prefills
    # whole prompts
    prefill_chunk: Callable | None = None
    # True for families with recurrent state (mamba, xlstm): the engine
    # prefills
    # them at exact prompt length, since right padding would advance the
    # recurrence
    recurrent: bool = False


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default ``cuda``).  ``init``
    takes a seed or a ``torch.Generator``."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        m = transformer
        return Model(
            cfg=cfg,
            device=dev,
            init=_init(m.transformer_init, cfg, dev),
            loss=lambda params, batch, **kw: m.transformer_loss(
                params, cfg, batch, **kw),
            apply=lambda params, batch, **kw: m.transformer_apply(
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
            loss=lambda params, batch, **kw: m.hybrid_loss(
                params, cfg, batch, **kw),
            apply=lambda params, batch, **kw: m.hybrid_apply(
                params, cfg, batch, **kw),
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
    if cfg.family == "ssm":
        m = xlstm_model
        return Model(
            cfg=cfg,
            device=dev,
            init=_init(m.xlstm_init, cfg, dev),
            loss=lambda params, batch, **kw: m.xlstm_loss(
                params, cfg, batch, **kw),
            apply=lambda params, batch, **kw: m.xlstm_apply(
                params, cfg, batch, **kw),
            init_cache=lambda batch, max_len=0: m.xlstm_init_cache(
                cfg, batch, max_len, device=dev),
            prefill=lambda params, batch, cache, **kw: m.xlstm_prefill(
                params, cfg, batch, cache, **kw),
            decode_step=lambda params, token, cache, pos, **kw:
                m.xlstm_decode_step(params, cfg, token, cache, pos, **kw),
            decode_step_slots=lambda params, token, cache, pos, **kw:
                m.xlstm_decode_step_slots(params, cfg, token, cache, pos,
                                          **kw),
            recurrent=True,
        )
    if cfg.family == "encdec":
        m = encdec
        return Model(
            cfg=cfg,
            device=dev,
            init=_init(m.encdec_init, cfg, dev),
            loss=lambda params, batch, **kw: m.encdec_loss(
                params, cfg, batch, **kw),
            apply=lambda params, batch, **kw: m.encdec_apply(
                params, cfg, batch, **kw),
            init_cache=lambda batch, max_len: m.encdec_init_cache(
                cfg, batch, max_len, device=dev),
            prefill=lambda params, batch, cache, **kw: m.encdec_prefill(
                params, cfg, batch, cache, **kw),
            decode_step=lambda params, token, cache, pos, **kw:
                m.encdec_decode_step(params, cfg, token, cache, pos, **kw),
            decode_step_slots=lambda params, token, cache, pos, **kw:
                m.encdec_decode_step_slots(params, cfg, token, cache, pos,
                                           **kw),
        )
    raise ValueError(f"unknown family {cfg.family!r}")


def _init(init_fn, cfg: ModelConfig, dev: torch.device) -> Callable:
    """``init(seed or torch.Generator)`` over ``init_fn(gen, cfg, device)``."""
    def init(seed):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_fn(gen, cfg, device=dev)
    return init


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

class InputSpec(NamedTuple):
    """A model input's shape and dtype, with no allocation (``repro``'s
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """VLM cells budget the patch prefix inside the cell's seq_len."""
    if cfg.family == "vlm" and cfg.num_patches:
        return max(seq_len - cfg.num_patches, 16)
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """:class:`InputSpec` stand-ins for the step function of this cell."""
    b = shape.global_batch
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        s = _text_len(cfg, shape.seq_len)
        specs = {"tokens": InputSpec((b, s), i32),
                 "labels": InputSpec((b, s), i32)}
        if cfg.family == "vlm":
            specs["patches"] = InputSpec(
                (b, cfg.num_patches, cfg.frontend_dim), torch.float32)
        if cfg.family == "encdec":
            specs["frames"] = InputSpec(
                (b, cfg.encoder_max_len, cfg.frontend_dim), torch.float32)
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs
    # decode: one new token against a cache of seq_len
    return {"token": InputSpec((b, 1), i32)}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator,
               vocab_cap: int | None = None) -> dict:
    """A random batch matching :func:`input_specs` (integers uniform below
    the vocabulary or ``vocab_cap``, floats standard normal), drawn from
    ``gen`` on its device.  The values cannot equal ``repro``'s (another
    generator); the shapes and dtypes do."""
    dev = gen.device
    v = vocab_cap or cfg.vocab_size
    out = {}
    for name, sd in input_specs(cfg, shape).items():
        if sd.dtype == torch.int32:
            out[name] = torch.randint(0, v, sd.shape, generator=gen,
                                      dtype=sd.dtype, device=dev)
        else:
            out[name] = torch.randn(sd.shape, generator=gen, dtype=sd.dtype,
                                    device=dev)
    return out


__all__ = ["Model", "build_model", "InputSpec", "input_specs", "make_batch"]
