"""The mesh of the train step: named axes over the ranks of a
``torch.distributed`` world (the JAX package's ``parallel/mesh.py``).

Each rank is one process holding one device. Axis order is dict order and
a rank's coordinates are its row-major index over the axis sizes, as the
JAX package's ``np.asarray(devices).reshape(sizes)`` lays devices out.
For every line of every axis, and of every tuple of axes, the mesh holds
one process group: the ranks whose other coordinates equal each other.
The axis collectives of :mod:`mpi_acx_torch.parallel.collective` run on
those groups.

``dist.new_group`` is collective over the whole world: every rank makes
every group, its own or not, in one fixed order (axis tuples by size, then
in dict order; lines in row-major order). Axes of size 1 take no group; a
mesh whose axes are all 1 needs no world, and its collectives are the
identity.
"""

from __future__ import annotations

import itertools
import math
from typing import Mapping, Sequence

import torch.distributed as dist

from mpi_acx_torch.parallel import collective


class PartitionSpec(tuple):
    """How a tensor lies on the mesh, the port's stand-in for JAX's
    ``PartitionSpec``: entry i names the mesh axis that dimension i is
    split over, or is ``None`` (replicated); dimensions past the last entry
    are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


# Process groups by (world, axis sizes): every rank makes the same meshes
# in the same order, so a mesh made again reuses its groups.
_GROUPS: dict = {}


def _world() -> tuple[int, int]:
    """(size, rank) of the initialized world, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Named axes over the ranks of the world. ``with mesh:`` makes it the
    mesh that the axis collectives read.

    ``shape`` maps axis names to sizes. Above size 1 the product of the
    sizes must equal the world's size, else ``ValueError`` names both."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        for name, n in self.shape.items():
            if n < 1:
                raise ValueError(f"mesh axis {name!r} has size {n}")
        n = math.prod(self.shape.values())
        world, self.rank = _world()
        if n > 1 and world != n:
            raise ValueError(
                f"mesh {self.shape} spans {n} ranks but the torch.distributed "
                f"world has {world}" + ("" if world > 1 else
                                        " (not initialized: see "
                                        "parallel.multihost.initialize)"))
        names = list(self.shape)
        sizes = [self.shape[a] for a in names]
        idx = self.rank
        coords = []
        for size in reversed(sizes):
            coords.append(idx % size)
            idx //= size
        self.coords = dict(zip(names, reversed(coords)))
        self._lines = {}
        if n > 1:
            self._make_groups(names, sizes)

    def _make_groups(self, names, sizes):
        key = (id(dist.group.WORLD), tuple(zip(names, sizes)))
        if key not in _GROUPS:
            big = [a for a, s in zip(names, sizes) if s > 1]
            strides = {a: math.prod(sizes[i + 1:])
                       for i, a in enumerate(names)}
            made = {}
            for k in range(1, len(big) + 1):
                for axes in itertools.combinations(big, k):
                    rest = [a for a in big if a not in axes]
                    for fixed in itertools.product(
                            *(range(self.shape[a]) for a in rest)):
                        base = sum(strides[a] * c
                                   for a, c in zip(rest, fixed))
                        ranks = sorted(
                            base + sum(strides[a] * c
                                       for a, c in zip(axes, cs))
                            for cs in itertools.product(
                                *(range(self.shape[a]) for a in axes)))
                        group = dist.new_group(ranks)
                        if self.rank in ranks:
                            made[axes] = (group, ranks)
            _GROUPS[key] = made
        self._lines = _GROUPS[key]

    def line(self, axes: Sequence[str]):
        """``(process group, global ranks in group order)`` of this rank's
        line over ``axes`` (names of axes larger than 1, in mesh order)."""
        return self._lines[tuple(axes)]

    def __enter__(self):
        collective.push_mesh(self)
        return self

    def __exit__(self, *exc):
        collective.pop_mesh(self)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def mesh_from_devices(axis_sizes: Mapping[str, int],
                      devices: Sequence | None = None) -> Mesh:
    """A mesh with the given axis names and sizes, in dict order. Axes
    above 1 need an initialized world of exactly the product's size
    (``ValueError`` naming both numbers otherwise). ``devices``, when
    given, must hold at least the product of the sizes."""
    sizes = dict(axis_sizes)
    n = math.prod(sizes.values())
    if devices is not None and len(devices) < n:
        raise ValueError(f"need {n} devices for mesh {sizes}, have "
                         f"{len(devices)}")
    return Mesh(sizes)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The 1-D ring mesh, axis "x", over ``n_devices`` ranks (the world's
    size when ``None``)."""
    return Mesh({"x": _world()[0] if n_devices is None else n_devices})
