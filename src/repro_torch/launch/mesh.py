"""Mesh descriptors and the rank-stacked layout.

The port runs on one card, so a mesh is a description — axis names and
sizes — that the dataplane resolves logical sharding names against and
records on every edge.  Placing a tensor on a one-card mesh is the
identity.

``make_mesh((R,), ("data",))`` describes R ranks on that one card.  A
tensor "inside" an explicit data-parallel step (``repro``'s
``shard_map`` body) carries a leading rank dim of size R: slice ``r`` is
what rank ``r`` holds.  The dataplane's explicit collectives take and
return such rank-stacked tensors (``core/dataplane.py``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    def axis_size(self, axes) -> int:
        """Ranks spanned by ``axes`` (a name or a tuple of names): the
        leading dim of a rank-stacked tensor over them."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in names:
            if a not in self.axis_names:
                raise KeyError(f"no mesh axis {a!r}; axes {self.axis_names}")
            n *= self.shape[self.axis_names.index(a)]
        return n


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


__all__ = ["Mesh", "make_mesh"]
