"""Build and load the hand-written Hopper kernels.

Each kernel is one CUDA C++ source with a plain C interface under its
package's ``csrc/``.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library in ``build/kernels/`` at the repository root (listed in
``.gitignore``) the first time it is used, and loaded with ``ctypes``.
The library's file name carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

# name -> source, relative to the package root
SOURCES = {
    "bounce": "kernels/dataplane/csrc/bounce.cu",
    "flash_attention": "kernels/flash_attention/csrc/flash_attention.cu",
    "ssm_scan": "kernels/ssm_scan/csrc/ssm_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = _PKG / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str, extra_flags: tuple[str, ...] = ()):
    """Start nvcc for one kernel; returns (Popen, tmp, out) or None when
    the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(_PKG / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every kernel, one ``nvcc`` per source, all started together.
    Returns each kernel's compiler output (empty when it was built
    before)."""
    started = {name: _start_build(name, extra_flags) for name in SOURCES}
    return {name: _finish_build(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """C function ``symbol`` of kernel ``name``'s library, its signature
    set once; later calls are a dictionary lookup."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[(name, symbol)] = fn
    return fn


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_SMS: dict[int, int] = {}     # device index -> SM count


def sm_count(device: int) -> int:
    """The number of SMs of card ``device``, queried once."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def raw_stream(device: int) -> int:
    """The handle of PyTorch's current stream on card ``device``, without
    building a ``torch.cuda.Stream`` object."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device)
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


__all__ = ["BUILD_DIR", "SOURCES", "KernelBuildError", "build_all", "load",
           "function", "library_path", "check", "raw_stream", "sm_count"]
