#!/usr/bin/env python3
"""Run the port's ``cuda``-marked tests on a machine with a card.

    python3 tools/card_tests.py [pytest arguments]

The machine with the card has PyTorch but no JAX.  The port's test files
import ``jax`` and ``repro`` at their top for their CPU parity tests, and
``tests/conftest.py`` imports ``repro``.  Here every import of ``jax``,
``repro`` or a submodule of either resolves to an inert stand-in; only
tests marked ``cuda`` run (``-m cuda``), and none of them touches JAX.
Without arguments it runs every test file that has such tests.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_TEST_FILES = ("tests/test_torch_attention.py",
                   "tests/test_torch_dataplane_kernel.py",
                   "tests/test_torch_ssm_scan.py",
                   "tests/test_torch_ssm_chunked.py",
                   "tests/test_torch_kvpool.py",
                   "tests/test_torch_collectives.py",
                   "tests/test_torch_train_attention.py",
                   "tests/test_torch_train_step.py",
                   "tests/test_torch_mediated_grad.py",
                   "tests/test_torch_chunking.py",
                   "tests/test_torch_verbs.py",
                   "tests/test_torch_transport.py",
                   "tests/test_torch_conn.py",
                   "tests/test_torch_serve_obs.py",
                   "tests/test_torch_elastic.py",
                   "tests/test_torch_moe_model.py",
                   "tests/test_torch_ssm_grad.py",
                   "tests/test_torch_encdec.py",
                   "tests/test_torch_ssm_bwd_kernel.py",
                   "tests/test_torch_flash_bwd_kernel.py",
                   "tests/test_torch_flash_f32_kernel.py",
                   "tests/test_torch_bench_card.py")
_STANDING_IN = ("jax", "repro")


class _StandIn(types.ModuleType):
    """A module whose every attribute, and every call, is a stand-in."""

    __path__: list = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _StandIn(f"{self.__name__}.{name}")

    def __call__(self, *args, **kwargs):
        return _StandIn(f"{self.__name__}()")


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in _STANDING_IN:
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        return _StandIn(spec.name)

    def exec_module(self, module):
        pass


def main(argv: list[str]) -> int:
    sys.meta_path.insert(0, _Finder())
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import pytest
    args = argv or [str(ROOT / f) for f in CARD_TEST_FILES]
    return pytest.main(["-q", "-p", "no:cacheprovider", "-m", "cuda", "-rs",
                        *args])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
