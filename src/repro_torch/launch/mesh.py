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

:func:`make_mesh` takes the place of ``repro.core.compat.make_mesh``.
``repro/core/compat.py`` has no counterpart in the port: it shims JAX
versions (``jax.make_mesh`` with axis types, ``shard_map`` under its old
and new names, the Pallas-TPU compiler parameters), and the port calls
none of them.  A ``shard_map`` body becomes a call over rank-stacked
tensors on the descriptor here.
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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``repro``'s production mesh as a descriptor: 16 x 16 ``(data,
    model)``, or 2 x 16 x 16 with a leading ``pod`` axis.  The port runs
    none of its ranks; the descriptor sizes sharding rules and specs."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_local_mesh(n: int | None = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh of a measured run: ``n`` ranks (default
    one, the card), ``n // model`` over data.  ``n > 1`` puts that many
    ranks on the one card, each a slice of a rank-stacked tensor."""
    n = 1 if n is None else int(n)
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return make_mesh((n // model, model), ("data", "model"))


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


__all__ = ["Mesh", "make_mesh", "make_local_mesh", "make_production_mesh",
           "mesh_axis_sizes"]
