"""Shapes and sharding specs as plain data: the port's counterparts of
``jax.ShapeDtypeStruct`` and ``jax.sharding.PartitionSpec``.

A :class:`PSpec` has one entry per tensor dim: ``None`` (not sharded), one
mesh-axis name, or a tuple of axis names (the dim split over those axes,
the first the slowest). A one-name tuple is stored as the name, as
``PartitionSpec`` stores it, so two specs that shard alike compare equal.
:func:`placements` maps a spec onto ``torch.distributed.tensor``
placements over a mesh's named dims, and :func:`shard_shape` gives the
shape one rank holds. Neither needs a process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """The shape and dtype of a tensor not yet allocated
    (``jax.ShapeDtypeStruct``'s counterpart)."""

    shape: tuple
    dtype: Any

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class PSpec(tuple):
    """``PartitionSpec``'s counterpart: a tuple of per-dim entries. It is a
    leaf of the port's trees (``_tree``), not a container."""

    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes that split tensor dim ``dim`` (``()``: none)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e


def placements(mesh_dim_names, spec: PSpec) -> tuple:
    """``spec`` as DTensor placements, one per mesh dim: ``Shard(i)`` where
    the axis splits tensor dim i, ``Replicate()`` elsewhere. Raises when an
    axis is not a mesh dim, splits two dims, or a dim's axes are not in
    mesh order (DTensor splits a dim over its mesh dims in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_dim_names)
    where = {}
    for i in range(len(spec)):
        axes = spec.axes(i)
        pos = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not a dim of the "
                                 f"mesh {names}")
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} splits two dims")
            where[a] = i
            pos.append(names.index(a))
        if pos != sorted(pos):
            raise ValueError(
                f"{spec}: dim {i} is split over {axes}, not in the mesh's "
                f"order {names}; DTensor cannot express that")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def shard_shape(shape, spec: PSpec, axis_sizes: dict) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor laid out by
    ``spec`` over a mesh of ``axis_sizes`` (``{axis: size}``); a dim that
    does not split evenly gives its largest block. ``spec=None`` is
    replicated."""
    if spec is None:
        return tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than shape {shape}")
    out = []
    for i, n in enumerate(shape):
        parts = math.prod(axis_sizes[a] for a in spec.axes(i))
        out.append(-(-n // parts))
    return tuple(out)
