"""Token embedding (vocab-sharded) and logits projection (tied or untied)."""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.layers.common import constrain, embed_init


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   tied: bool = True, device=None) -> dict:
    p = {"tok": embed_init(gen, vocab, dim, device=device)}
    if not tied:
        p["head"] = embed_init(gen, vocab, dim, device=device)
    return p


def embed(params: dict, tokens: torch.Tensor, dtype, *, scale: bool = True,
          dp=None) -> torch.Tensor:
    tab = constrain(dp, params["tok"], ("vocab", "embed"), tag="embed/table")
    # gather, then cast: the same values as casting the whole table first
    x = tab[tokens].to(dtype)
    if scale:  # gemma-style sqrt(d) embedding scale, rounded to the dtype
        x = x * _embed_scale(x.shape[-1], dtype, x.device)
    return constrain(dp, x, ("batch", "seq", "embed"), tag="embed/out")


@functools.lru_cache(maxsize=16)
def _embed_scale(dim: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """sqrt(dim) rounded to ``dtype``, as a 0-dim tensor on ``device``
    made once and never written (so a forward uploads no constant).  A
    raw Python ``sqrt(dim)`` would multiply with the unrounded value."""
    with torch.inference_mode(False):    # a normal tensor, whoever asks
        return torch.tensor(math.sqrt(dim), dtype=dtype, device=device)


def logits(params: dict, x: torch.Tensor, dp=None,
           softcap_val: float = 0.0) -> torch.Tensor:
    """float32 logits of the working-dtype hiddens against the table cast
    to the working dtype (``preferred_element_type=float32`` in JAX: the
    products of two bf16 values are exact in float32)."""
    tab = params.get("head", params["tok"])
    tab = constrain(dp, tab, ("vocab", "embed"), tag="logits/table")
    out = torch.matmul(x.float(), tab.to(x.dtype).float().t())
    if softcap_val > 0:
        out = softcap_val * torch.tanh(out / softcap_val)
    return constrain(dp, out, ("batch", "seq", "vocab"), tag="logits/out")


__all__ = ["embedding_init", "embed", "logits"]
