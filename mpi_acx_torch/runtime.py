"""ctypes binding to the native host plane (``build/libtpuacx.so``), taking
tensors.

The port's own copy of the JAX package's binding: init and finalize,
enqueued sends and receives on the host queue, host waits, partitioned
channels, the device<->proxy flag bridge (``publish_partition_flags`` /
``fetch_partition_flags``), a barrier, a max all-reduce, the proxy's
counters, and the resilience, fleet-membership, metrics, live-telemetry,
causal-tracing and flight-recorder calls the serving loop reports through.
The C surface is the library's public API (``include/mpi-acx.h``,
``include/compat/mpi.h``), the same one the C tests and the JAX package
call, so ranks of either package meet on one wire.

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
import json
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
QUEUE_GRAPH = 1         # MPIX_QUEUE_CUDA_GRAPH (no graph-queue path here yet)
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


# MemberState values of the fleet membership table (include/acx/membership.h;
# MPIX_FLEET_* in include/mpi-acx.h). Indices are the C enum: do not reorder.
FLEET_STATE_NAMES = ("unknown", "joining", "active", "draining", "left",
                     "dead")

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
        u64, d, s = ctypes.c_uint64, ctypes.c_double, ctypes.c_char_p
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
            "cudaStreamSynchronize": ([p], i),
            "MPIX_Set_deadline": ([d], i),
            "MPIX_Get_deadline": ([ctypes.POINTER(d)], i),
            "MPIX_Op_status": ([p, ip, ip, ip], i),
            "acx_resilience_stats": ([u64p], None),
            "acx_recovery_stats": ([u64p], None),
            "acx_drain": ([d], i),
            "MPIX_Fleet_epoch": ([], u64),
            "MPIX_Fleet_view": ([i32p, i], i),
            "MPIX_Fleet_leave": ([d], i),
            "acx_fleet_stats": ([u64p], None),
            "acx_metrics_enabled": ([], i),
            "acx_metrics_snapshot": ([s, i], i),
            "acx_metrics_prom": ([s, i], i),
            "acx_metrics_dump_json": ([s], i),
            "acx_tseries_enabled": ([], i),
            "acx_tseries_sample_now": ([], i),
            "acx_tseries_live_json": ([s, i], i),
            "acx_tseries_annotate": ([s], None),
            "acx_span_app_begin": ([u64], None),
            "acx_span_app_end": ([], None),
            "acx_flight_dump": ([s], i),
            "acx_flight_stats": ([u64p], None),
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
        self._left = False             # fleet_leave() was called

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

    def stream_sync(self) -> None:
        """Wait for the native default host queue to drain (the library's
        host shim of ``cudaStreamSynchronize``, on which the enqueued ops
        run). It waits for no work on the card."""
        self._lib.cudaStreamSynchronize(None)

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

    def wait_partitioned(self, req) -> Status:
        """Wait for a partitioned round to complete (its errors raise as
        :meth:`wait`'s do)."""
        return self.wait(req)

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
        """The proxy's counters, with :meth:`resilience_stats` and
        :meth:`recovery_stats` merged in."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.acx_proxy_stats(out)
        stats = {"sweeps": out[0], "ops_issued": out[1],
                 "ops_completed": out[2], "slots_reclaimed": out[3]}
        stats.update(self.resilience_stats())
        stats.update(self.recovery_stats())
        return stats

    def _counters(self, fn, names) -> dict:
        out = (ctypes.c_uint64 * len(names))()
        fn(out)
        return dict(zip(names, out))

    def _json_text(self, fn) -> str:
        """The text a sizing C call returns: probe with (NULL, 0), then
        fill, with slack, until the text fits (live counters can gain
        digits between the probe and the fill)."""
        n = fn(None, 0)
        while True:
            cap = n + 256
            buf = ctypes.create_string_buffer(cap)
            n = fn(buf, cap)
            if n < cap:
                return buf.value.decode()

    # -- resilience plane ---------------------------------------------------

    def set_deadline(self, timeout_ms: float) -> None:
        """Deadline of every op issued after this call (0 disables): an op
        past it completes with ERR_TIMEOUT instead of blocking forever."""
        if self._lib.MPIX_Set_deadline(float(timeout_ms)) != 0:
            raise ValueError(f"bad deadline {timeout_ms!r} (must be >= 0)")

    def get_deadline(self) -> float:
        out = ctypes.c_double(0.0)
        if self._lib.MPIX_Get_deadline(ctypes.byref(out)) != 0:
            raise RuntimeError("MPIX_Get_deadline failed")
        return out.value

    def op_status(self, req) -> dict:
        """Nonblocking probe of a request: its lifecycle state (the flag
        word), its first error and its issue attempts (above 1: the retry
        path fired)."""
        st, err, att = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        if self._lib.MPIX_Op_status(req, ctypes.byref(st), ctypes.byref(err),
                                    ctypes.byref(att)) != 0:
            raise RuntimeError("MPIX_Op_status: not a live request")
        return {"state": st.value, "error": err.value,
                "attempts": att.value}

    def resilience_stats(self) -> dict:
        """Process-wide resilience counters: proxy retries and timeouts,
        injected-fault hits, heartbeats and dead peers."""
        return self._counters(self._lib.acx_resilience_stats, (
            "retries", "timeouts", "fault_drops", "fault_delays",
            "fault_fails", "hb_sent", "hb_recv", "peers_dead"))

    def drain(self, timeout_ms: float = 1000.0) -> int:
        """MPIX_Drain: wait up to ``timeout_ms`` for every in-flight op,
        then cancel the stragglers with a typed error so every waiter
        returns. Returns the number of ops cancelled (0: a clean drain)."""
        n = self._lib.acx_drain(float(timeout_ms))
        if n < 0:
            raise RuntimeError("acx_drain: runtime not initialized")
        return n

    def recovery_stats(self) -> dict:
        """Process-wide survivable-link counters: reconnects, frames
        replayed, CRC rejects, NAKs sent, ops cancelled by a drain, links
        mid-reconnect and links whose replay buffer overran."""
        return self._counters(self._lib.acx_recovery_stats, (
            "reconnects", "replayed_frames", "crc_rejects", "naks_sent",
            "drained_slots", "links_recovering", "replay_broken_links"))

    # -- fleet membership ---------------------------------------------------

    def fleet_epoch(self) -> int:
        """This rank's fleet epoch: it grows with every membership verdict
        the rank adopts (a join, a graceful leave, a death)."""
        return int(self._lib.MPIX_Fleet_epoch())

    def fleet_view(self) -> list:
        """This rank's membership view: one state name
        (``FLEET_STATE_NAMES``) per rank slot."""
        states = (ctypes.c_int32 * max(self.size, 1))()
        n = self._lib.MPIX_Fleet_view(states, self.size)
        return [FLEET_STATE_NAMES[states[i]]
                if 0 <= states[i] < len(FLEET_STATE_NAMES) else "unknown"
                for i in range(max(n, 0))]

    def fleet_stats(self) -> dict:
        """Membership counters: epoch, joins, leaves and deaths adopted,
        and the rank slots ACTIVE now."""
        return self._counters(self._lib.acx_fleet_stats, (
            "epoch", "joins", "leaves", "deaths", "active"))

    def fleet_leave(self, timeout_ms: float = 2000.0) -> int:
        """Leave the fleet: drain (up to ``timeout_ms``), announce LEFT to
        every peer and give up the rendezvous listener for a replacement.
        Returns the ops the drain cancelled. :meth:`finalize` then skips
        MPI_Finalize's barrier with a rank set this rank has left."""
        n = self._lib.MPIX_Fleet_leave(float(timeout_ms))
        if n < 0:
            raise RuntimeError("MPIX_Fleet_leave: runtime not initialized")
        self._left = True
        return n

    # -- metrics plane (ACX_METRICS) ----------------------------------------

    def metrics_enabled(self) -> bool:
        """True iff ACX_METRICS was set when the library loaded."""
        return bool(self._lib.acx_metrics_enabled())

    def metrics(self) -> dict:
        """The native metrics registry: ``{"enabled", "counters",
        "histograms"}`` (counters read 0 with ACX_METRICS unset)."""
        return json.loads(self._json_text(self._lib.acx_metrics_snapshot))

    def metrics_prom(self) -> str:
        """The registry in Prometheus text exposition format."""
        return self._json_text(self._lib.acx_metrics_prom)

    def metrics_dump(self, path: str) -> None:
        """Write the registry snapshot to ``path`` as JSON."""
        if self._lib.acx_metrics_dump_json(path.encode()) != 0:
            raise RuntimeError(f"acx_metrics_dump_json({path!r}) failed")

    # -- live telemetry (ACX_TSERIES) ---------------------------------------

    def tseries_enabled(self) -> bool:
        """True iff ACX_TSERIES sampling is armed."""
        return bool(self._lib.acx_tseries_enabled())

    def live_metrics(self) -> dict:
        """A fresh telemetry sample as a dict (the record the sampler
        appends to its ``.tseries.jsonl``, the last annotation under
        ``"app"``), or ``{"enabled": False}`` with ACX_TSERIES unset."""
        if self._lib.acx_tseries_sample_now() < 0:
            return {"enabled": False}
        text = self._json_text(self._lib.acx_tseries_live_json)
        return json.loads(text) if text else {}

    def tseries_annotate(self, fragment: dict) -> None:
        """Attach a JSON fragment (serving SLOs, say) to later telemetry
        samples under ``"app"``; a no-op while sampling is off."""
        self._lib.acx_tseries_annotate(
            json.dumps(fragment, separators=(",", ":")).encode())

    # -- causal tracing (ACX_TRACE) -----------------------------------------

    def span_app_begin(self, request_id: int) -> None:
        """Tie every op enqueued until :meth:`span_app_end` to
        ``request_id`` (nonzero; the latest begin wins, no nesting)."""
        self._lib.acx_span_app_begin(request_id)

    def span_app_end(self) -> None:
        self._lib.acx_span_app_end()

    # -- flight recorder ----------------------------------------------------

    def hang_report(self, path: Optional[str] = None) -> str:
        """Write this rank's flight dump for tools/acx_doctor.py to
        ``<prefix>.rank<r>.flight.json`` (prefix: ``path``, else
        $ACX_FLIGHT, else "acx"); returns the file name."""
        prefix = path if path is not None else os.environ.get(
            "ACX_FLIGHT", "acx")
        arg = path.encode() if path is not None else None
        if self._lib.acx_flight_dump(arg) != 0:
            raise RuntimeError(f"acx_flight_dump({path!r}) failed")
        return f"{prefix}.rank{self.rank}.flight.json"

    def flight_stats(self) -> dict:
        """Flight-recorder counters: events recorded, ring capacity,
        stall warnings, watchdog hang dumps and dump files written."""
        return self._counters(self._lib.acx_flight_stats, (
            "recorded", "capacity", "stall_warns", "hang_dumps",
            "dumps_written"))

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
        if not self._left:
            # MPI_Finalize barriers with the rank set this rank has left.
            self._lib.MPI_Finalize()
        self._open = False
