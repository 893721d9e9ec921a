"""The partitioned exchange on the collective plane: the JAX package's
``parallel/partitioned.py`` over :mod:`mpi_acx_torch.parallel.collective`.

The reference's partitioned communication (``MPI_Psend_init`` with
device-side ``MPIX_Pready``/``MPIX_Parrived``, reference
partitioned.cu:36-231) overlaps a kernel's production of message
fragments with their transmission. Here, as in the JAX package, the
partitions are a loop whose steps each move one partition with a
``ppermute`` and compute on it. The JAX package's ``lax.scan`` lets XLA
overlap step k's ppermute with its compute (async collective start and
done); this Python loop issues each ppermute and waits for it, so that
overlap is not claimed here. The flag kernels of the device plane
(``ops/flags.py``) are not on this path.

* :func:`partitioned_ring_exchange`: a partitioned neighbour exchange with
  a consumer applied to each partition as it lands.
* :func:`partitioned_pipeline`: produce partition k, send it one ring step
  right, consume it on arrival.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpi_acx_torch.parallel import collective as col


def partitioned_ring_exchange(x, axis_name: str, partitions: int,
                              consume: Callable | None = None):
    """Send this rank's ``x`` one ring step right in ``partitions``
    chunks (its leading dim must divide into them), applying ``consume``
    to each chunk as it arrives. Returns the received shard, ``consume``
    applied chunkwise (the identity when ``None``)."""
    n = col.axis_size(axis_name)
    chunks = x.reshape((partitions, -1) + tuple(x.shape[1:]))
    out = []
    for chunk in chunks:
        arrived = col.ppermute(chunk, axis_name, col._ring_perm(n, 1))
        out.append(arrived if consume is None else consume(arrived))
    return torch.stack(out).reshape((-1,) + tuple(x.shape[1:]))


def partitioned_pipeline(produce: Callable, consume: Callable, init_acc,
                         partitions: int, axis_name: str):
    """For k in range(partitions): ``produce(k)`` a payload (the same shape
    each k), send it one ring step right, and fold what arrives from the
    left neighbour into the accumulator with ``consume(acc, payload)``.
    Returns the final accumulator."""
    n = col.axis_size(axis_name)
    acc = init_acc
    for k in range(partitions):
        arrived = col.ppermute(produce(k), axis_name, col._ring_perm(n, 1))
        acc = consume(acc, arrived)
    return acc
