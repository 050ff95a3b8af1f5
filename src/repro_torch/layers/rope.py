"""Rotary position embeddings, with per-layer theta (gemma3 uses a larger
base on global layers than on sliding-window layers), and whisper's fixed
sinusoidal positions."""

from __future__ import annotations

import functools

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim//2,), computed in float32 on
    ``device``.  One tensor per (head_dim, theta, device), computed once
    and never written: a layer's forward uploads no constant."""
    return _rope_freqs(int(head_dim), float(theta), torch.device(
        "cpu" if device is None else device))


@functools.lru_cache(maxsize=64)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):    # a normal tensor, whoever asks
        exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                                device=device) / head_dim
        base = torch.tensor(theta, dtype=torch.float32, device=device)
        return 1.0 / (base ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotate ``x`` of shape (..., seq, heads, head_dim) by ``positions``
    of shape (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs   # (..., S, hd/2)
    angles = angles[..., :, None, :]                            # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (max_len, dim), computed
    in float32 and cast to ``dtype``.  One tensor per (max_len, dim,
    dtype, device), computed once and never written."""
    return _sinusoidal(int(max_len), int(dim), dtype, torch.device(
        "cpu" if device is None else device))


@functools.lru_cache(maxsize=64)
def _sinusoidal(max_len: int, dim: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):    # a normal tensor, whoever asks
        f32 = dict(dtype=torch.float32, device=device)
        pos = torch.arange(max_len, **f32)[:, None]
        i = torch.arange(dim // 2, **f32)[None, :]
        angle = pos / torch.pow(torch.tensor(10_000.0, **f32), 2 * i / dim)
        return torch.cat([torch.sin(angle), torch.cos(angle)],
                         dim=-1).to(dtype)


__all__ = ["rope_freqs", "apply_rope", "sinusoidal_positions"]
