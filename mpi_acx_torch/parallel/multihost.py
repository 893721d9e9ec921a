"""The multi-process runtime of the train step (the JAX package's
``parallel/multihost.py``): one process per rank over
``torch.distributed``.

A launcher exports ``ACX_COORDINATOR`` (and ``ACX_NPROCS`` /
``ACX_PROC_ID``, or runs the ranks under ``build/acxrun``, which sets
``ACX_SIZE`` / ``ACX_RANK``), and each rank calls :func:`initialize` bare.
Without a coordinator it is a no-op, so the same program runs alone.

Each process is one rank holding one device and its own shard of every
array, so the JAX package's host-local and global arrays are one and the
same here (:func:`host_local_to_global`).

The backend is the caller's choice: ``"nccl"`` where every rank has a card
of its own, ``"gloo"`` otherwise (several ranks sharing one card, or the
CPU). Nothing switches backend by itself, and a failed initialization
raises.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from mpi_acx_torch.parallel.collective import _from_wire, _to_wire
from mpi_acx_torch.parallel.mesh import _GROUPS, Mesh, PartitionSpec, \
    mesh_from_devices

_initialized = False
_DEFAULT_TIMEOUT_S = 60.0


def _init_method(address: str) -> str:
    """A ``torch.distributed`` init method: a URL (``tcp://``,
    ``file://``) as it is, a JAX-style ``host:port`` as ``tcp://``."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               backend: str = "gloo") -> None:
    """Bootstrap the process group (MPIX_Init's process-level half).

    Arguments fall back to ACX_COORDINATOR / ACX_NPROCS / ACX_PROC_ID, and
    the process count and id to acxrun's ACX_SIZE / ACX_RANK. No
    coordinator: a no-op. Idempotent.

    ``timeout_s`` (fallback ACX_INIT_TIMEOUT_S, else 60 s) bounds the
    rendezvous and every collective of the default group: a peer that
    never starts raises instead of hanging the job. Failures raise
    ``RuntimeError`` naming the coordinator/nprocs/proc triple.

    ``backend="nccl"`` binds the rank to card ``process_id % count`` and
    builds its communicator at once, so a refusal shows here."""
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "ACX_COORDINATOR")
    if coordinator_address is None:
        return  # single-process mode
    if num_processes is None:
        e = os.environ.get("ACX_NPROCS") or os.environ.get("ACX_SIZE")
        if e is None:
            raise ValueError(
                "ACX_COORDINATOR is set but the process count isn't: "
                "export ACX_NPROCS (or run under acxrun, which sets "
                "ACX_SIZE) — defaulting to 1 would silently split the job")
        num_processes = int(e)
    if process_id is None:
        e = os.environ.get("ACX_PROC_ID") or os.environ.get("ACX_RANK")
        if e is None:
            raise ValueError(
                "ACX_COORDINATOR is set but the process id isn't: export "
                "ACX_PROC_ID (or run under acxrun, which sets ACX_RANK)")
        process_id = int(e)
    if timeout_s is None:
        e = os.environ.get("ACX_INIT_TIMEOUT_S")
        timeout_s = float(e) if e else _DEFAULT_TIMEOUT_S
    kwargs = {}
    if backend == "nccl":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    try:
        dist.init_process_group(
            backend, init_method=_init_method(coordinator_address),
            world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=timeout_s), **kwargs)
    except Exception as e:
        raise RuntimeError(
            f"tpu-acx: multihost initialize failed (coordinator="
            f"{coordinator_address}, nprocs={num_processes}, "
            f"proc={process_id}, backend={backend}): {e}") from e
    _initialized = True


def shutdown() -> None:
    """Tear the process group down, and the meshes' groups with it (the
    counterpart of :func:`initialize`; a no-op without one)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    _initialized = False


def recovery_budget_s(max_attempts: Optional[int] = None,
                      backoff_ms: Optional[float] = None,
                      cap_ms: float = 2000.0,
                      margin_s: float = 1.0) -> float:
    """Worst-case seconds a lost link may spend in RECOVERING before the
    native transport gives up and declares the peer dead: ACX_RECONNECT_MAX
    dial attempts with exponential backoff from ACX_RECONNECT_BACKOFF_MS,
    each wait capped at ``cap_ms``, plus ``margin_s`` for the handshake. A
    coordinator waiting on a wedged worker should wait at least this
    long."""
    if max_attempts is None:
        max_attempts = int(os.environ.get("ACX_RECONNECT_MAX", "5"))
    if backoff_ms is None:
        backoff_ms = float(os.environ.get("ACX_RECONNECT_BACKOFF_MS", "50"))
    total_ms = 0.0
    for attempt in range(1, max(0, max_attempts)):
        # The native ladder: the wait after attempt k is backoff *
        # 2^(k-1), capped.
        total_ms += min(backoff_ms * (2.0 ** (attempt - 1)), cap_ms)
    return total_ms / 1000.0 + margin_s


def fleet_join_budget_s(timeout_ms: Optional[float] = None,
                        margin_s: float = 1.0) -> float:
    """Worst-case seconds a joining replacement rank may spend dialing the
    fleet's rendezvous listeners before the native transport gives up:
    ACX_FLEET_JOIN_TIMEOUT_MS plus ``margin_s`` for the JOIN handshakes."""
    if timeout_ms is None:
        timeout_ms = float(os.environ.get("ACX_FLEET_JOIN_TIMEOUT_MS",
                                          "10000"))
    return timeout_ms / 1000.0 + margin_s


def fleet_snapshot(runtime) -> dict:
    """One-call fleet summary off a :class:`mpi_acx_torch.runtime.Runtime`:
    ``{"epoch", "view", "stats"}``. The view is this process's."""
    return {"epoch": runtime.fleet_epoch(),
            "view": runtime.fleet_view(),
            "stats": runtime.fleet_stats()}


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_sizes: Mapping[str, int]) -> Mesh:
    """The mesh over all processes with named axes (dict order = major to
    minor): the product of the sizes must equal the process count."""
    n = 1
    for size in axis_sizes.values():
        n *= size
    if n != process_count():
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} ranks, the "
                         f"job has {process_count()}")
    return mesh_from_devices(axis_sizes)


def hybrid_mesh(ici_axes: Mapping[str, int],
                dcn_axis: str = "dcn") -> Mesh:
    """An outer axis spanning the processes and the given inner axes over
    each process's devices. A process holds one device here, so the inner
    axes must all be 1."""
    local = 1
    n = 1
    for size in ici_axes.values():
        n *= size
    if n != local:
        raise ValueError(f"ici axes {dict(ici_axes)} need {n} local "
                         f"devices, a process has {local}")
    return global_mesh({dcn_axis: process_count(), **ici_axes})


def host_local_to_global(x, mesh: Mesh, pspec: PartitionSpec):
    """A process holds its own shard of every array, so its host-local
    block already is its part of the global array: ``x`` as a tensor."""
    del mesh, pspec
    return torch.as_tensor(x)


def global_to_host_local(x, mesh: Mesh, pspec: PartitionSpec):
    """The inverse of :func:`host_local_to_global`: this process's shard
    is the array it holds."""
    del mesh, pspec
    return x


def _broadcast_leaf(x):
    t = torch.as_tensor(x)
    group = dist.group.WORLD
    buf = _to_wire(t, group)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.broadcast(buf, src=0)
    out = _from_wire(buf, t)
    return out.numpy() if not isinstance(x, torch.Tensor) else out


def broadcast_from_host0(x):
    """Process 0's pytree (dicts, lists, tuples of tensors or numpy
    arrays) on every process: init once and broadcast."""
    if not dist.is_initialized():
        return x
    if isinstance(x, dict):
        return {k: broadcast_from_host0(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(broadcast_from_host0(v) for v in x)
    return _broadcast_leaf(x)


def sync(name: str = "acx_sync") -> None:
    """Cross-process barrier (MPI_Barrier's counterpart)."""
    del name
    if dist.is_initialized():
        dist.barrier()


def replicated(mesh: Mesh) -> PartitionSpec:
    """The layout of a value replicated on every rank of ``mesh``."""
    del mesh
    return PartitionSpec()
