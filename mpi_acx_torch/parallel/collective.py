"""Axis collectives over the active mesh (the JAX package's
``lax.axis_size``/``axis_index``/``psum``/``pmean``/``all_gather``/
``ppermute`` as the train step uses them, and ``parallel/collective.py``'s
``_ring_perm``).

A function reads its axis from the mesh made active by ``with mesh:``
(:class:`mpi_acx_torch.parallel.mesh.Mesh`). On an axis of size 1 each is
exactly the identity (``ppermute`` gives zeros where the permutation
sends nothing to the one rank, as in JAX). Above size 1 each raises
``NotImplementedError``: it does not pretend to reduce or exchange.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MULTI_RANK = ("mesh axes larger than 1: multi-rank training over "
              "torch.distributed is not ported yet (ROADMAP.md §A, "
              "'multi-rank training')")
_ACTIVE: list = []
Axes = Union[str, Tuple[str, ...]]


def push_mesh(mesh) -> None:
    _ACTIVE.append(mesh)


def pop_mesh(mesh) -> None:
    if not _ACTIVE or _ACTIVE[-1] is not mesh:
        raise RuntimeError("meshes must be exited in the order entered")
    _ACTIVE.pop()


def _ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


def _one(axes: Axes, op: str) -> None:
    """Raise unless every axis in ``axes`` is on the active mesh with size
    1."""
    if not _ACTIVE:
        raise RuntimeError(f"{op}: no active mesh (use `with mesh:`)")
    shape = _ACTIVE[-1].shape
    for axis in (axes,) if isinstance(axes, str) else axes:
        if axis not in shape:
            raise NameError(f"{op}: unknown mesh axis {axis!r} (mesh axes "
                            f"{tuple(shape)})")
        if shape[axis] != 1:
            raise NotImplementedError(f"{op} over {axis}={shape[axis]}: "
                                      f"{MULTI_RANK}")


def axis_size(axis: str) -> int:
    _one(axis, "axis_size")
    return 1


def axis_index(axis: str) -> int:
    _one(axis, "axis_index")
    return 0


def psum(x, axes: Axes):
    _one(axes, "psum")
    return x


def pmean(x, axes: Axes):
    _one(axes, "pmean")
    return x


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Gather over the mesh axis: ``tiled`` concatenates along ``axis``,
    else stacks in a new dimension there."""
    _one(axis_name, "all_gather")
    return x if tiled else x.unsqueeze(axis)


def ppermute(x, axis_name: str, perm: Sequence[tuple[int, int]]):
    """Send this rank's ``x`` along the (source, destination) pairs of
    ``perm``; a rank that receives nothing gets zeros."""
    _one(axis_name, "ppermute")
    for pair in perm:
        if tuple(pair) != (0, 0):
            raise ValueError(f"ppermute: pair {pair} outside an axis of "
                             f"size 1")
    return x if perm else torch.zeros_like(x)
