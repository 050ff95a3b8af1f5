"""Memory-region registration — the security half of CoRD.

The paper (§4): "If the application passes an invalid address, the NIC
returns an error but does not access any memory that was not explicitly
provided to the application."  Here the dataplane only moves tensors
belonging to *registered memory regions*: registration is a control-plane
operation, and in ``cord``/``socket`` mode every dataplane op validates
its operand against the registry (shape/dtype signature match).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.telemetry import dtype_name


class MRError(Exception):
    """Dataplane operand does not belong to a registered memory region."""


def _dtype_str(x) -> str:
    dt = x.dtype
    return dt if isinstance(dt, str) else dtype_name(dt)


@dataclass(frozen=True)
class MemoryRegion:
    name: str
    shape: tuple[int, ...]
    dtype: str
    lkey: int                   # local key, as in ibverbs
    tenant: str = "default"

    def matches(self, x) -> bool:
        return tuple(x.shape) == self.shape and _dtype_str(x) == self.dtype


class MRRegistry:
    """Control-plane registry of communicable memory regions."""

    def __init__(self) -> None:
        self._regions: dict[str, MemoryRegion] = {}
        self._next_key = 0x1000

    def reg_mr(self, name: str, x, tenant: str = "default") -> MemoryRegion:
        """Register a tensor (or anything with ``shape``/``dtype``)."""
        self._next_key += 1
        mr = MemoryRegion(name=name, shape=tuple(x.shape), dtype=_dtype_str(x),
                          lkey=self._next_key, tenant=tenant)
        self._regions[name] = mr
        return mr

    def dereg_mr(self, name: str) -> None:
        self._regions.pop(name, None)

    def lookup(self, name: str) -> MemoryRegion | None:
        return self._regions.get(name)

    def check(self, name: str, x) -> MemoryRegion:
        """Validate that ``x`` matches registered region ``name``."""
        mr = self._regions.get(name)
        if mr is None:
            raise MRError(f"dataplane op on unregistered memory region {name!r}")
        if not mr.matches(x):
            raise MRError(
                f"MR {name!r} signature mismatch: registered "
                f"{mr.shape}/{mr.dtype}, got {tuple(x.shape)}/{_dtype_str(x)}")
        return mr

    def __len__(self) -> int:
        return len(self._regions)


__all__ = ["MemoryRegion", "MRRegistry", "MRError"]
