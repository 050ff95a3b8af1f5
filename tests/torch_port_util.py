"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters reach the port through ``repro_torch.models.from_jax_params``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

PROBE_ITERS = 200_000


def pin_calibration(monkeypatch, ns_per_iter: float = 1.0) -> None:
    """Pin the delay calibration of both packages to one slope, so
    iteration counts and kernel counters compare exactly."""
    from repro.core import techniques as jtech
    from repro.kernels.dataplane import ops as jops

    from repro_torch.core import techniques as ttech

    monkeypatch.setitem(jtech._CALIBRATION,
                        (jax.default_backend(), PROBE_ITERS), ns_per_iter)
    monkeypatch.setattr(jops, "_KERNEL_CALIBRATION",
                        {jax.default_backend(): ns_per_iter})
    monkeypatch.setitem(ttech._CALIBRATION, ("cpu", PROBE_ITERS),
                        ns_per_iter)


def to_np(x) -> np.ndarray:
    """A numpy copy of a JAX array or a torch tensor (bf16 via float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x, dtype=np.float32) if str(x.dtype) == "bfloat16" \
        else np.asarray(x)


def bits(x) -> np.ndarray:
    """Raw-bit integer view of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.element_size() == 1:
            return x.view(torch.uint8).numpy()
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return x.view(view[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32,
                   8: np.int64}[a.dtype.itemsize])


def jax_params_np(params) -> dict:
    return jax.tree.map(np.asarray, params)


def cuda_device() -> torch.device:
    """The card for a ``cuda``-marked test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module of smoke-size tests.  Their ops
    are too small to gain from threads, and the test workers share the
    machine's cores: idle intra-op threads that spin for work make small
    ops many times slower for every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
