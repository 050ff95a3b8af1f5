"""The port stands alone: repro_torch and chip_smoke.py never import JAX
or repro, and entry points never fall back to the CPU on their own.

Tolerance: not numeric — import sets and raised errors are checked
exactly."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
from repro_torch.configs import get_model_config
from repro_torch.configs.base import DataplaneConfig
from repro_torch.core import Dataplane
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
cfg = get_model_config("gemma3-1b", smoke=True)
m = build_model(cfg, device="cpu")
dp = Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
               mesh=make_mesh((1,), ("data",)), device="cpu")
logits, _ = m.prefill(m.init(0), {"tokens": torch.arange(8)[None]},
                      m.init_cache(1, 8), dp=dp)
assert logits.shape == (1, 1, cfg.vocab_size), logits.shape
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print("MODULES", len(mods), "BAD", bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.endswith("BAD []"), line
    assert int(line.split()[1]) >= 25


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    assert path.exists(), path
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_cpu_fallback():
    _no_cuda()
    from repro_torch.configs import get_model_config
    from repro_torch.core import Dataplane
    from repro_torch.launch import serve
    from repro_torch.models import build_model, from_jax_params

    cfg = get_model_config("gemma3-1b", smoke=True)
    for call in (lambda: build_model(cfg),
                 lambda: Dataplane(),
                 lambda: from_jax_params({}, cfg),
                 lambda: serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_tensors_take_plain_versions_only():
    """A wrapper runs its plain version because the tensor lies on the
    CPU, and counts no kernel launch."""
    from repro_torch.kernels.dataplane import bounce
    from repro_torch.kernels.flash_attention import ops

    before = (bounce.LAUNCHES, ops.LAUNCHES)
    bounce.mediated_cost(torch.ones(40), 10, 1)
    q = torch.ones(1, 8, 2, 16)
    ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert (bounce.LAUNCHES, ops.LAUNCHES) == before
    # a meta tensor takes neither: the kernel's shape rule runs, for the
    # cost counter, and nothing launches
    out, ctrs = bounce.mediated_cost(torch.ones(4, device="meta"), 10, 1)
    assert out.is_meta and ctrs.is_meta and tuple(ctrs.shape) == (1, 2)
    assert (bounce.LAUNCHES, ops.LAUNCHES) == before


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    version (an XPU), which a CPU-only build cannot make for real."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(*shape):
    return torch.ones(*shape).as_subclass(_Elsewhere)


def _bounce(x):
    from repro_torch.kernels.dataplane import bounce
    return bounce.mediated_cost(x, 10, 1)


def _stall(x):
    from repro_torch.kernels.dataplane import stall
    return stall.stall(x, 10)


def _flash(x):
    from repro_torch.kernels.flash_attention import ops
    q = x.reshape(1, 8, 2, 16)
    return ops.flash_attention(q, q, q)


def _scan(x):
    from repro_torch.kernels.ssm_scan import ops
    dt = x.reshape(1, 4, 64)
    a, bc, h0 = _elsewhere(64, 2), _elsewhere(1, 4, 2), _elsewhere(1, 64, 2)
    return ops.ssm_scan(dt, dt, a, bc, bc, h0)


@pytest.mark.parametrize("wrapper, match", [
    (_bounce, "no dataplane kernel"), (_stall, "no stall kernel"),
    (_flash, "no flash-attention kernel"), (_scan, "no ssm_scan kernel")],
    ids=["bounce", "stall", "flash_attention", "ssm_scan"])
def test_devices_with_no_kernel_raise(wrapper, match):
    """A tensor on neither the card, the CPU nor ``meta`` is refused: no
    wrapper falls back to its plain version on it."""
    x = _elsewhere(256)
    assert x.device.type == "xpu" and not (x.is_cuda or x.is_meta)
    with pytest.raises(ValueError, match=match):
        wrapper(x)
