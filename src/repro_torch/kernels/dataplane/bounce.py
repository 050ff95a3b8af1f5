"""Dataplane kernels: the mediation data-movement primitives.

One CUDA kernel (``csrc/bounce.cu``, the Hopper port of the Pallas
``_bounce_kernel``) serves both entry points:

* :func:`bounce_copy` — the zero-copy-removed bounce-buffer copy: the
  payload goes through shared memory (the bounce buffer) and out again,
  with ``copies - 1`` extra round trips through a second shared region.
* :func:`mediated_cost` — the fused-mediation cost kernel: the same copy
  plus a serial delay chain burned inside the kernel after the copy, with
  per-chunk cost counters ``(n_chunks, 2)`` int32 (``COST_ITERS``,
  ``COST_COPIES``) over the TPU kernel's 8192-element chunks.

The kernel moves the payload through a ring in shared memory: a
persistent grid of at most one block per SM, sized to the payload
(:func:`ring_plan`), each block walking its tiles through
``RING_STAGES`` stages with ``cp.async.bulk`` loads and stores behind
full/empty mbarriers.  Unaligned head and tail bytes, and payloads whose
address disagrees with the output's modulo 16, are copied with ordinary
loads and stores inside the kernel.  Outputs are bit-identical to their
input: the payload is only ever moved, never computed on.

A wrapper given a CPU tensor runs the kernel's plain version (roll /
roll-back copies as in ``core/techniques.staged_copy``, the delay chain on
the host, counters from the same chunk split); given a CUDA tensor it
launches the kernel or raises; given a ``meta`` tensor it calls the
operator ``repro_torch::bounce``, the kernel's shape rule, which a
dispatch mode sees (``analysis/cost.py`` prices it).  ``LAUNCHES`` counts
kernel launches.
Given a tensor that wants a gradient, either wrapper goes through an
autograd function whose backward is the identity on ``x``, so a mediated
edge inside a loss passes its gradient on unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import techniques as tech
from repro_torch.kernels import build

DEFAULT_CHUNK_ELEMS = 8192

# Columns of the per-chunk cost-counter output.
COST_ITERS = 0    # delay iterations burned for this chunk
COST_COPIES = 1   # bounce passes this chunk made through the buffer
NUM_COST_COLS = 2

# kernel launches since the count was last set to 0
LAUNCHES = 0

# the kernel's ring (csrc/bounce.cu): stages per block, tile bytes
RING_STAGES = 4
RING_TILE_MAX = 32768
RING_TILE_MIN = 2048


@functools.lru_cache(maxsize=4096)
def _split(n: int, delay_iters: int, chunk_elems: int) -> tuple[int, int, int]:
    """(chunk, n_chunks, iters_per_chunk) — the TPU kernel's split: the
    total delay divided evenly over the chunks, rounded up."""
    chunk = max(1, min(chunk_elems, n))
    n_full, tail = divmod(n, chunk)
    n_chunks = n_full + (1 if tail else 0)
    iters_per_chunk = -(-delay_iters // n_chunks) if delay_iters > 0 else 0
    return chunk, n_chunks, iters_per_chunk


def _plain(x: torch.Tensor, copies: int, delay_iters: int,
           chunk_elems: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, on any device."""
    _, n_chunks, ipc = _split(x.numel(), delay_iters, chunk_elems)
    out = tech.staged_copy_plain(x, copies) if copies > 0 else x.clone()
    tok = tech.delay_scalar(n_chunks * ipc)
    live = int(tok == tok)
    out = tech.tie(out, tok)
    ctrs = torch.tensor([[ipc * live, copies]], dtype=torch.int32,
                        device=x.device).repeat(n_chunks, 1)
    return out, ctrs


def ring_plan(n_bytes: int, sms: int, x_offset: int = 0
              ) -> tuple[int, int, int]:
    """``(tile, n_tiles, grid)`` of the kernel's ring for a payload of
    ``n_bytes`` at ``x_offset`` bytes past a 16-byte boundary, written to
    an aligned output on a card of ``sms`` SMs — ``make_plan`` in
    ``csrc/bounce.cu``, mirrored.  The body between the unaligned head
    and tail is cut evenly over the SMs into tiles of 2-32 KB (multiples
    of 16 bytes); the grid is one block per tile, at most one per SM."""
    head = min((16 - x_offset % 16) % 16, n_bytes)
    body = (n_bytes - head) & ~15
    per = -(-body // sms)
    per = (per + 15) & ~15
    tile = min(max(per, RING_TILE_MIN), RING_TILE_MAX)
    n_tiles = -(-body // tile)
    return tile, n_tiles, max(1, min(n_tiles, sms))


# x, out, ctrs; n_bytes, n_chunks; copies, iters_per_chunk; device, sms;
# stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p]
_FN = None


def _bind():
    """The launch function, built and bound on first use."""
    global _FN
    _FN = build.function("bounce", "bounce_launch", _ARGTYPES)
    return _FN


@functools.lru_cache(maxsize=256)
def _counter_like(dev: int, n_chunks: int) -> torch.Tensor:
    """A held ``(n_chunks, 2)`` int32 tensor on card ``dev`` whose
    ``empty_like`` is the cheapest way to allocate the counters."""
    return torch.empty((n_chunks, NUM_COST_COLS), dtype=torch.int32,
                       device=dev)


def _kernel(x: torch.Tensor, copies: int, delay_iters: int,
            chunk_elems: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bounce.cu`` on a CUDA tensor: one output and one
    counter allocation, no device query after the first call."""
    global LAUNCHES
    if not x.is_contiguous():
        raise ValueError("bounce kernel needs a contiguous tensor")
    _, n_chunks, ipc = _split(x.numel(), delay_iters, chunk_elems)
    dev = x.get_device()
    out = torch.empty_like(x)
    ctrs = torch.empty_like(_counter_like(dev, n_chunks))
    err = (_FN or _bind())(x.data_ptr(), out.data_ptr(), ctrs.data_ptr(),
                           x.nbytes, n_chunks, copies, ipc, dev,
                           build.sm_count(dev),
                           build.raw_stream(dev))
    if err:
        build.check(err, "bounce_launch")
    LAUNCHES += 1
    return out, ctrs


def _meta_outputs(x, copies, delay_iters, chunk_elems):
    """The kernel's outputs on ``meta``: the copy and the counters."""
    _, n_chunks, _ = _split(x.numel(), delay_iters, chunk_elems)
    return torch.empty_like(x), torch.empty(
        (n_chunks, NUM_COST_COLS), dtype=torch.int32, device=x.device)


# the shape rule as an operator with a Meta kernel only, so that a
# dispatch mode sees the call with its arguments; the card's launch stays
# a direct ``ctypes`` call, off the dispatcher's host cost
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("bounce(Tensor x, int copies, int delay_iters, "
            "int chunk_elems) -> (Tensor, Tensor)")
_LIB.impl("bounce", _meta_outputs, "Meta")
_shape_rule = torch.ops.repro_torch.bounce


def _run(x, copies: int, delay_iters: int, chunk_elems: int):
    if x.is_cuda:
        return _kernel(x, copies, delay_iters, chunk_elems)
    if x.is_meta:
        return _shape_rule(x, copies, delay_iters, chunk_elems)
    if x.device.type != "cpu":
        raise ValueError(f"no dataplane kernel for device {x.device}")
    return _plain(x, copies, delay_iters, chunk_elems)


class _Mediated(torch.autograd.Function):
    """A launch with a gradient: the output is a copy of ``x``, so the
    cotangent crosses unchanged, as through ``repro``'s ``tie`` and
    ``staged_copy``.  The backward launches nothing: a transpose burns no
    delay.  The counters carry no gradient."""

    @staticmethod
    def forward(ctx, x, copies, delay_iters, chunk_elems):
        # an edge in a backward graph may see a view the serve path never
        # does: the kernel copies a flat payload
        out, ctrs = _run(x.contiguous(), copies, delay_iters, chunk_elems)
        ctx.mark_non_differentiable(ctrs)
        return out, ctrs

    @staticmethod
    def backward(ctx, g_out, g_ctrs):
        return g_out, None, None, None


def _launch(x, *, copies: int, delay_iters: int, chunk_elems: int):
    """The kernel (or its plain version on a CPU tensor); through
    :class:`_Mediated` when ``x`` wants a gradient."""
    args = (int(copies), int(delay_iters), int(chunk_elems))
    if x.requires_grad and torch.is_grad_enabled():
        return _Mediated.apply(x, *args)
    return _run(x, *args)


def bounce_copy(x: torch.Tensor, copies: int = 1, *,
                chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> torch.Tensor:
    """``copies`` bounce-buffer passes of ``x``.  Drop-in for
    ``techniques.staged_copy``: bit-identical output.  ``copies <= 0`` or
    an empty ``x`` is the identity (returns ``x`` itself)."""
    if copies <= 0 or x.numel() == 0:
        return x
    out, _ = _launch(x, copies=copies, delay_iters=0,
                     chunk_elems=chunk_elems)
    return out


def kernel_cost_totals(nelems: int, delay_iters: int, copies: int = 0,
                       chunk_elems: int = DEFAULT_CHUNK_ELEMS
                       ) -> tuple[int, int]:
    """Static ``(total_iters, total_copy_passes)`` the cost kernel's
    counters sum to for a payload of ``nelems`` elements — the exact
    chunk split of :func:`mediated_cost`, mirrored host-side."""
    if (delay_iters <= 0 and copies <= 0) or nelems <= 0:
        return 0, 0
    _, n_chunks, ipc = _split(nelems, delay_iters, chunk_elems)
    return ipc * n_chunks, copies * n_chunks


def mediated_cost(x: torch.Tensor, delay_iters: int, copies: int = 0, *,
                  chunk_elems: int = DEFAULT_CHUNK_ELEMS):
    """One kernel launch covering a fused mediation side's cost: burn
    ``delay_iters`` of serial work and make ``copies`` bounce passes,
    returning ``(out, counters)``: ``out`` bit-identical to ``x`` and
    ``counters`` the per-chunk ``(n_chunks, 2)`` int32 cost output.  With
    no work (or an empty ``x``) returns ``(x, zeros((1, 2)))``."""
    if (delay_iters <= 0 and copies <= 0) or x.numel() == 0:
        return x, torch.zeros((1, NUM_COST_COLS), dtype=torch.int32,
                              device=x.device)
    return _launch(x, copies=copies, delay_iters=delay_iters,
                   chunk_elems=chunk_elems)


def mediated_cost_plain(x: torch.Tensor, delay_iters: int, copies: int = 0,
                        *, chunk_elems: int = DEFAULT_CHUNK_ELEMS):
    """The plain version of :func:`mediated_cost` on any device — what the
    kernel is held against on the card."""
    return _plain(x, int(copies), int(delay_iters), int(chunk_elems))


__all__ = ["bounce_copy", "mediated_cost", "mediated_cost_plain",
           "kernel_cost_totals", "ring_plan", "DEFAULT_CHUNK_ELEMS",
           "COST_ITERS", "COST_COPIES", "NUM_COST_COLS", "LAUNCHES"]
