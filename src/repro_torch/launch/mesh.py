"""Mesh descriptors.

The port runs on one card, so a mesh is a description — axis names and
sizes — that the dataplane resolves logical sharding names against and
records on every edge.  Placing a tensor on a one-card mesh is the
identity; the collectives over several cards arrive with a later slice.
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


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


__all__ = ["Mesh", "make_mesh"]
