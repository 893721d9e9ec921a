"""ctypes binding to the native host plane (``build/libtpuacx.so``), taking
tensors.

The port's own copy of what the device-triggered exchange needs from the
native runtime: init and finalize, enqueued sends and receives on the host
queue, host waits, partitioned channels, the device<->proxy flag bridge
(``publish_partition_flags`` / ``fetch_partition_flags``), a barrier, a max
all-reduce and the proxy's counters. The C surface is the library's public
API (``include/mpi-acx.h``, ``include/compat/mpi.h``), the same one the C
tests and the JAX package call, so ranks of either package meet on one wire.

Buffers are tensors:

* A CPU tensor is handed over as its ``.numpy()`` view, with no copy, so the
  native side reads and writes the tensor's own memory. Wire buffers that a
  CUDA stream fills or drains should be pinned (``pin_memory=True``) so the
  copies to and from the card run asynchronously.
* bfloat16 has no MPI type, so it travels as a ``uint8`` view of its bytes.
* A CUDA tensor handed to :meth:`Runtime.isend_enqueue` is first staged into
  a pinned host buffer (a copy on the current stream, waited on by an event,
  never a device-wide synchronize). That buffer is held until
  :meth:`Runtime.wait` returns for the request: the lifetime rule of the C
  API, under which a send's buffer must outlive the operation.

Run multi-process under ``build/acxrun -np N python script.py``: the
transport picks up the rank layout acxrun hands its children. A single
process gets the loopback transport (rank 0 of 1).

The native library also defines a host shim under the CUDA runtime's names
(``cudaMemcpy``, ``cudaStreamSynchronize``, ``cudaLaunchHostFunc``, ...;
``src/runtime/cuda_shim.cc``). It is therefore loaded with ``RTLD_LOCAL``,
after ``torch``, so that neither it nor PyTorch's CUDA runtime binds to the
other's symbols, and this module never synchronises the device through it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "libtpuacx.so")
_ACXRUN_PATH = os.path.join(_REPO_ROOT, "build", "acxrun")
# Never RTLD_GLOBAL: see the module docstring.
DLOPEN_MODE = os.RTLD_NOW | os.RTLD_LOCAL

_lib: Optional[ctypes.CDLL] = None

# Status.error values of the resilience plane (include/acx/state.h).
# ERR_TRUNCATE stays a Status-level condition (MPI semantics); the three
# below are raised as typed exceptions by wait().
ERR_TRUNCATE = 17
ERR_TIMEOUT = 19
ERR_PEER_DEAD = 20
ERR_INJECTED = 21

QUEUE_STREAM = 0        # MPIX_QUEUE_CUDA_STREAM: the host execution queue
_COMM_WORLD = 0
_MPI_MAX = 0
_MPI_IN_PLACE = ctypes.c_void_p(2 ** 64 - 1)   # (void *)-1


class AcxError(RuntimeError):
    """A host-plane operation completed with a resilience-plane error."""

    def __init__(self, message: str, error: int, source: int, tag: int):
        super().__init__(message)
        self.error = error
        self.source = source
        self.tag = tag


class AcxTimeoutError(AcxError):
    """Op deadline expired or retries exhausted (MPIX_ERR_TIMEOUT)."""


class AcxPeerDeadError(AcxError):
    """Peer declared dead: EOF or heartbeat timeout (MPIX_ERR_PEER_DEAD)."""


_ERRORS = {ERR_TIMEOUT: (AcxTimeoutError, "op timed out"),
           ERR_PEER_DEAD: (AcxPeerDeadError, "peer dead"),
           ERR_INJECTED: (AcxError, "injected fault")}


def _build_native() -> None:
    """Build the native library and its tools (``make -C <repo> lib
    tools``); raises with make's output when the build fails."""
    res = subprocess.run(["make", "-C", _REPO_ROOT, "lib", "tools"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"make lib tools failed ({res.returncode}):\n"
                           f"{res.stdout}")


def lib() -> ctypes.CDLL:
    """The native runtime library, built first if it is missing."""
    global _lib
    if _lib is None:
        if not os.path.exists(_LIB_PATH):
            _build_native()
        L = ctypes.CDLL(_LIB_PATH, mode=DLOPEN_MODE)
        i, p, ip = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        sig = {
            "MPI_Init_thread": ([p, p, i, ip], i),
            "MPI_Finalize": ([], i),
            "MPI_Comm_rank": ([i, ip], i),
            "MPI_Comm_size": ([i, ip], i),
            "MPI_Barrier": ([i], i),
            "MPI_Allreduce": ([p, p, i, i, i, i], i),
            "MPIX_Init": ([], i),
            "MPIX_Finalize": ([], i),
            "MPIX_Isend_enqueue": ([p, i, i, i, i, i, p, i, p], i),
            "MPIX_Irecv_enqueue": ([p, i, i, i, i, i, p, i, p], i),
            "MPIX_Wait": ([p, p], i),
            "MPIX_Psend_init": ([p, i, ctypes.c_longlong, i, i, i, i, i, p],
                                i),
            "MPIX_Precv_init": ([p, i, ctypes.c_longlong, i, i, i, i, i, p],
                                i),
            "MPIX_Start": ([p], i),
            "MPIX_Pready": ([i, p], i),
            "MPIX_Parrived": ([p, i, ip], i),
            "MPIX_Request_free": ([p], i),
            "acx_request_partition_slots": ([p, i64p, i], i),
            "acx_flags_publish": ([i64p, i32p, i], i),
            "acx_flags_fetch": ([i64p, i32p, i], i),
            "acx_proxy_stats": ([u64p], None),
        }
        for name, (args, res) in sig.items():
            fn = getattr(L, name)
            fn.argtypes = args
            fn.restype = res
        _lib = L
    return _lib


def acxrun_path() -> str:
    """``build/acxrun``, the launcher of multi-rank jobs (built if
    missing)."""
    if not os.path.exists(_ACXRUN_PATH):
        _build_native()
    return _ACXRUN_PATH


class Status(ctypes.Structure):
    """Mirror of the compat MPI_Status (include/compat/mpi.h)."""

    _fields_ = [
        ("MPI_SOURCE", ctypes.c_int),
        ("MPI_TAG", ctypes.c_int),
        ("MPI_ERROR", ctypes.c_int),
        ("acx_bytes", ctypes.c_size_t),
    ]


_DTYPE_TO_MPI = {
    np.dtype(np.int8): 1,     # MPI_CHAR
    np.dtype(np.uint8): 2,    # MPI_BYTE
    np.dtype(np.int32): 3,    # MPI_INT
    np.dtype(np.float32): 4,  # MPI_FLOAT
    np.dtype(np.float64): 5,  # MPI_DOUBLE
    np.dtype(np.int64): 6,    # MPI_INT64_T
}


def _host_view(buf) -> np.ndarray:
    """The numpy array the native side reads or writes for ``buf``: a
    contiguous CPU tensor's ``.numpy()`` view (bfloat16 as its ``uint8``
    bytes), or ``buf`` itself for a numpy array. No copy is made; raises for
    a tensor that is not a contiguous CPU tensor of a type the wire
    carries."""
    if isinstance(buf, np.ndarray):
        arr = buf
    else:
        if buf.device.type != "cpu":
            raise TypeError(f"wire buffer on {buf.device}: pass a (pinned) "
                            "CPU tensor")
        if not buf.is_contiguous():
            raise ValueError("wire buffer must be contiguous")
        if buf.dtype == torch.bfloat16:
            buf = buf.view(torch.uint8)
        arr = buf.numpy()
    if arr.dtype not in _DTYPE_TO_MPI or not arr.flags.c_contiguous:
        raise TypeError(f"wire buffer of dtype {arr.dtype}: the wire carries "
                        f"{sorted(str(d) for d in _DTYPE_TO_MPI)} (and "
                        "bfloat16 as uint8)")
    return arr


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def _stage(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``t``, complete when this returns:
    the copy runs on the current stream and only its event is waited on."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return buf


class Runtime:
    """One process's handle on the native runtime.

    Wraps MPI_Init_thread + MPIX_Init and exposes enqueued and partitioned
    operations on tensors. Buffers must stay alive until their op completes
    (the C API's rule); a CUDA tensor's staging buffer is kept here until
    its request is waited on. Stream-ordered triggers
    (:mod:`mpi_acx_torch.triggers`) keep their pending sends and trigger
    threads on this object, so they live exactly as long as it does.
    """

    def __init__(self) -> None:
        L = lib()
        provided = ctypes.c_int(0)
        L.MPI_Init_thread(None, None, 3, ctypes.byref(provided))
        if L.MPIX_Init() != 0:
            raise RuntimeError("MPIX_Init failed")
        self._lib = L
        rank, size = ctypes.c_int(0), ctypes.c_int(0)
        L.MPI_Comm_rank(_COMM_WORLD, ctypes.byref(rank))
        L.MPI_Comm_size(_COMM_WORLD, ctypes.byref(size))
        self.rank = rank.value
        self.size = size.value
        self._staged = {}              # request handle -> staging buffer
        self._inprogram_sends = []     # triggers: (request, host buffer)
        self._triggers = {}            # triggers: stream id -> trigger thread
        self._open = True

    # -- enqueued ops (default host queue) ---------------------------------

    def _enqueue(self, fn, arr: np.ndarray, peer: int, tag: int):
        req = ctypes.c_void_p(None)
        queue = ctypes.c_void_p(None)   # NULL handle = default queue
        rc = fn(_ptr(arr), arr.size, _DTYPE_TO_MPI[arr.dtype], peer, tag,
                _COMM_WORLD, ctypes.byref(req), QUEUE_STREAM,
                ctypes.byref(queue))
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} failed")
        return req

    def isend_enqueue(self, buf, dest: int, tag: int = 0):
        """MPIX_Isend_enqueue on the default host queue; returns a request.
        ``buf``: a CPU tensor or numpy array (sent from its own memory), or
        a CUDA tensor (staged into a pinned buffer held until ``wait``)."""
        keep = None
        if isinstance(buf, torch.Tensor) and buf.device.type == "cuda":
            buf = keep = _stage(buf)
        req = self._enqueue(self._lib.MPIX_Isend_enqueue, _host_view(buf),
                            dest, tag)
        if keep is not None:
            self._staged[req.value] = keep
        return req

    def irecv_enqueue(self, buf, source: int, tag: int = 0):
        """MPIX_Irecv_enqueue into ``buf``, a CPU tensor or numpy array,
        which must stay alive until ``wait`` returns."""
        return self._enqueue(self._lib.MPIX_Irecv_enqueue, _host_view(buf),
                             source, tag)

    def wait(self, req) -> Status:
        """Block until the request completes. Resilience-plane failures
        (op deadline expired / retries exhausted / peer dead / injected
        fault) surface as typed exceptions; ERR_TRUNCATE stays in the
        returned Status (MPI semantics)."""
        handle = req.value
        st = Status()
        rc = self._lib.MPIX_Wait(ctypes.byref(req), ctypes.byref(st))
        if rc != 0:
            raise RuntimeError("MPIX_Wait failed")
        self._staged.pop(handle, None)
        if st.MPI_ERROR in _ERRORS:
            cls, name = _ERRORS[st.MPI_ERROR]
            raise cls(f"tpu-acx: {name} (error={st.MPI_ERROR}, "
                      f"source={st.MPI_SOURCE}, tag={st.MPI_TAG})",
                      st.MPI_ERROR, st.MPI_SOURCE, st.MPI_TAG)
        return st

    # -- partitioned ops ----------------------------------------------------

    def _pinit(self, fn, buf, partitions: int, peer: int, tag: int):
        arr = _host_view(buf)
        if partitions <= 0 or arr.size % partitions:
            raise ValueError(f"{arr.size} elements do not split into "
                             f"{partitions} partitions")
        req = ctypes.c_void_p(None)
        rc = fn(_ptr(arr), partitions, arr.size // partitions,
                _DTYPE_TO_MPI[arr.dtype], peer, tag, _COMM_WORLD, 0,
                ctypes.byref(req))
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} failed")
        return req

    def psend_init(self, buf, partitions: int, dest: int, tag: int = 0):
        """MPIX_Psend_init over ``buf`` (a CPU tensor, pinned when a stream
        fills it), split into ``partitions`` equal partitions."""
        return self._pinit(self._lib.MPIX_Psend_init, buf, partitions, dest,
                           tag)

    def precv_init(self, buf, partitions: int, source: int, tag: int = 0):
        """MPIX_Precv_init into ``buf`` (a CPU tensor), ``partitions``
        equal partitions."""
        return self._pinit(self._lib.MPIX_Precv_init, buf, partitions,
                           source, tag)

    def start(self, req) -> None:
        if self._lib.MPIX_Start(ctypes.byref(req)) != 0:
            raise RuntimeError("MPIX_Start failed")

    def pready(self, partition: int, req) -> None:
        """Host-side MPIX_Pready of one partition."""
        if self._lib.MPIX_Pready(partition, ctypes.byref(req)) != 0:
            raise RuntimeError("MPIX_Pready failed")

    def parrived(self, req, partition: int) -> bool:
        """Host-side MPIX_Parrived: has ``partition`` arrived?"""
        flag = ctypes.c_int(0)
        if self._lib.MPIX_Parrived(ctypes.byref(req), partition,
                                   ctypes.byref(flag)) != 0:
            raise RuntimeError("MPIX_Parrived failed")
        return bool(flag.value)

    def request_free(self, req) -> None:
        if self._lib.MPIX_Request_free(ctypes.byref(req)) != 0:
            raise RuntimeError("MPIX_Request_free failed")

    # -- device<->proxy flag bridge ----------------------------------------
    # A kernel mutates a per-partition int32 flag table on the card
    # (mpi_acx_torch.ops.flags); these calls mirror its words into / out of
    # the native table the proxy polls.

    def partition_slots(self, req) -> np.ndarray:
        """Native flag-table slot of each partition of ``req`` (int64)."""
        # The C call writes up to cap entries but returns the full count:
        # probe with cap=0, then fetch exactly n (never truncate silently).
        n = self._lib.acx_request_partition_slots(req, None, 0)
        if n < 0:
            raise RuntimeError("not a partitioned request")
        out = np.zeros(max(n, 1), dtype=np.int64)
        got = self._lib.acx_request_partition_slots(
            req, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        if got != n:
            raise RuntimeError(f"partition count changed ({n} -> {got})")
        return out[:n].copy()

    def publish_partition_flags(self, req, flags) -> int:
        """Mirror a flag table (one int32 word per partition, the protocol
        constants of ops.flags; a CPU tensor or numpy array) into the native
        table: every partition marked PENDING is published to the proxy
        exactly like a host MPIX_Pready. Idempotent per partition (a CAS in
        the native layer). Returns how many partitions were newly
        published."""
        slots = self.partition_slots(req)
        vals = _host_view(flags)
        if vals.dtype != np.int32 or vals.size < len(slots):
            raise ValueError(f"flag table {vals.dtype}[{vals.size}] for "
                             f"{len(slots)} partitions")
        n = self._lib.acx_flags_publish(
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(slots))
        if n < 0:
            raise RuntimeError("acx_flags_publish failed")
        return n

    def fetch_partition_flags(self, req) -> torch.Tensor:
        """Snapshot the native flag word of each partition (COMPLETED once
        the proxy saw it arrive), as an int32 CPU tensor, for lifting into
        the device flag table a parrived kernel polls."""
        slots = self.partition_slots(req)
        out = torch.zeros(len(slots), dtype=torch.int32)
        if self._lib.acx_flags_fetch(
                slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out.numpy().ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(slots)) != 0:
            raise RuntimeError("acx_flags_fetch failed")
        return out

    # -- collectives / lifecycle -------------------------------------------

    def barrier(self) -> None:
        self._lib.MPI_Barrier(_COMM_WORLD)

    def allreduce_max(self, value: int) -> int:
        buf = np.array([value], dtype=np.int32)
        self._lib.MPI_Allreduce(_MPI_IN_PLACE, _ptr(buf), 1,
                                _DTYPE_TO_MPI[buf.dtype], _MPI_MAX,
                                _COMM_WORLD)
        return int(buf[0])

    def proxy_stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.acx_proxy_stats(out)
        return {"sweeps": out[0], "ops_issued": out[1],
                "ops_completed": out[2], "slots_reclaimed": out[3]}

    def finalize(self) -> None:
        """Stop the trigger threads, then MPIX_Finalize and MPI_Finalize
        (which barriers with every rank)."""
        if not self._open:
            return
        for trig in self._triggers.values():
            trig.close()
        self._triggers.clear()
        if self._inprogram_sends:
            # In-program sends were triggered but never waited
            # (triggers.drain_sends): their host buffers and slots are
            # about to be torn down under them.
            import sys
            print(f"tpu-acx: finalize: {len(self._inprogram_sends)} "
                  f"in-program send(s) never drained (triggers.drain_sends)",
                  file=sys.stderr)
        self._lib.MPIX_Finalize()
        self._lib.MPI_Finalize()
        self._open = False
