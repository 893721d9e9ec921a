"""Stream-ordered MPIX triggers: a transfer fires when the card's stream
reaches a point, not when the host gets there.

The reference arms CUDA stream memory operations so that the device
reaching a point in its queue fires an MPIX operation; the JAX package
compiles ordered ``io_callback`` nodes into a jitted program for the same
effect. Here the point is a CUDA event recorded on the current stream.
:func:`when_reached` hands the event and a host action to the trigger
thread of the (runtime, stream) pair, which waits on the event and then
runs the action. One thread per stream runs its actions in the order they
were placed, so triggers placed on one stream fire in stream order, and the
host thread never synchronises the device: it goes on issuing work while
earlier triggers wait for the card.

:func:`send_in_program` copies a tensor into a pinned host buffer on the
stream (a non-blocking copy), places a trigger after the copy, and the
trigger enqueues the native send of that buffer. :func:`recv_in_program`
enqueues a native receive, waits for it and returns the tensor on the
caller's device. On a CPU tensor a trigger fires at once.

Lifetime rule (the C API's): a send's buffer must stay alive until the
operation completes. The pending sends, (request, host buffer) pairs, live
on the Runtime object, and :func:`drain_sends` waits them out, like
MPIX_Wait on the C side.
"""

from __future__ import annotations

import queue
import threading

import torch

from mpi_acx_torch.device import resolve_device


class _Trigger:
    """The trigger thread of one (runtime, stream): runs each placed action
    after its event has completed, in placement order. An action's error is
    kept and raised by the next :meth:`flush`."""

    def __init__(self, name: str):
        self._q = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                event, action = item
                if self._error is None:
                    if event is not None:
                        event.synchronize()
                    action()
            except Exception as e:  # reported by flush() on the host thread
                self._error = e
            finally:
                self._q.task_done()

    def put(self, event, action) -> None:
        self._q.put((event, action))

    def flush(self) -> None:
        """Wait until every placed action has run; raise the first error."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()


def _trigger_of(rt, stream) -> _Trigger:
    key = stream.cuda_stream
    trig = rt._triggers.get(key)
    if trig is None:
        trig = rt._triggers[key] = _Trigger(f"acx-trigger-{key:x}")
    return trig


def when_reached(rt, action, device=None) -> None:
    """Run ``action()`` (on the runtime's trigger thread) once the current
    stream of ``device`` has reached this point; ``device`` of type ``cpu``
    runs it here and now. ``None`` means the GPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        action()
        return
    stream = torch.cuda.current_stream(dev)
    event = torch.cuda.Event()
    event.record(stream)
    _trigger_of(rt, stream).put(event, action)


def flush(rt) -> None:
    """Wait until every trigger placed on this runtime has fired; raises
    the first error an action raised."""
    for trig in list(rt._triggers.values()):
        trig.flush()


def send_in_program(rt, x: torch.Tensor, dest: int, tag: int = 0):
    """Place a send trigger at this point of the stream.

    When the stream reaches it, the value ``x`` had there is handed to the
    native runtime as an enqueued send to ``dest`` (MPIX_Isend_enqueue). A
    CUDA tensor is copied into a pinned buffer on the stream first; a CPU
    tensor is copied and sent at once. Returns ``x`` unchanged."""
    if x.device.type == "cpu":
        buf = x.detach().contiguous().clone()
    else:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)

    def fire():
        rt._inprogram_sends.append((rt.isend_enqueue(buf, dest, tag), buf))

    when_reached(rt, fire, x.device)
    return x


def recv_in_program(rt, shape, dtype, source: int, tag: int = 0,
                    device=None) -> torch.Tensor:
    """Enqueue a native receive from ``source``, wait for it, and return
    the received tensor on ``device`` (``None`` means the GPU; the copy to
    the card is issued on the current stream without waiting for it)."""
    dev = resolve_device(device)
    buf = torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")
    rt.wait(rt.irecv_enqueue(buf, source, tag))
    return buf if dev.type == "cpu" else buf.to(dev, non_blocking=True)


def drain_sends(rt) -> int:
    """Host side: fire every placed trigger, then wait out every send they
    enqueued (the MPIX_Wait half of the enqueue/wait pair). Returns how
    many sends were completed."""
    flush(rt)
    pending = rt._inprogram_sends
    done = 0
    while pending:
        req, _buf = pending.pop()
        rt.wait(req)
        done += 1
    return done
