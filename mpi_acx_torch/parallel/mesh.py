"""The mesh of the train step: named axes and their sizes (the JAX
package's ``parallel/mesh.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from mpi_acx_torch.parallel import collective
from mpi_acx_torch.parallel.collective import MULTI_RANK


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes. ``with mesh:`` makes it the mesh the
    axis collectives of :mod:`mpi_acx_torch.parallel.collective` read."""
    shape: Mapping[str, int]

    def __enter__(self):
        collective.push_mesh(self)
        return self

    def __exit__(self, *exc):
        collective.pop_mesh(self)


def mesh_from_devices(axis_sizes: Mapping[str, int],
                      devices: Sequence | None = None) -> Mesh:
    """A mesh with the given axis names and sizes, in dict order. Every
    axis must have size 1 in this port (one device); a larger axis raises
    ``NotImplementedError``. ``devices``, when given, must hold at least
    the product of the sizes."""
    sizes = dict(axis_sizes)
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {name!r} has size {n}")
        if n > 1:
            raise NotImplementedError(f"{name}={n}: {MULTI_RANK}")
    n = math.prod(sizes.values())
    if devices is not None and len(devices) < n:
        raise ValueError(f"need {n} devices for mesh {sizes}, have "
                         f"{len(devices)}")
    return Mesh(sizes)
