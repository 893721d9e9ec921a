"""Token data for training (the JAX package's ``data.py``): a memory-mapped
token file, seeded window batches, and a background prefetch onto the
card.

* :class:`TokenDataset` — a zero-copy ``np.memmap`` view of a flat binary
  token file (uint16 by default: GPT-2's 50257 fits).
* :func:`batches` — int32 [batch, seq + 1] windows, sequential or drawn
  from ``np.random.default_rng(seed)``. This module keeps its own copy of
  the JAX package's numpy code, so the windows are bit-equal to it on the
  same file and seed.
* :func:`prefetch` — a bounded background thread that stages the next
  batches on the device while the current step runs. ``device`` takes
  the place of the JAX ``sharding``: on a one-device mesh there is no
  sharding to give.

On a CUDA device the worker copies each batch from pinned host memory on
a side stream and records an event; the consumer's stream waits on that
event before the batch is handed out, so no kernel reads a batch before
its copy has landed, and ``record_stream`` keeps the caching allocator
from reusing the buffer while the consumer's stream may still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from mpi_acx_torch.device import resolve_device


class TokenDataset:
    """Zero-copy view over a flat binary token file.

    ``dtype`` must match the file's layout (uint16 covers vocabs up to
    65536 at half the IO of uint32). An empty file raises ``ValueError``.
    """

    def __init__(self, path: str, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) == 0:
            raise ValueError(f"empty token file: {path}")

    @classmethod
    def from_array(cls, arr) -> "TokenDataset":
        """In-memory variant (tests, synthetic data): the same interface
        without a file."""
        self = cls.__new__(cls)
        self.tokens = np.asarray(arr)
        return self

    def __len__(self) -> int:
        return len(self.tokens)


def batches(ds: TokenDataset, batch: int, seq: int, *,
            seed: Optional[int] = 0,
            n_batches: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yields int32 [batch, seq+1] numpy windows (``w[:, :-1]`` is the
    input, ``w[:, 1:]`` the target).

    ``seed=None`` walks the file sequentially without overlap (epoch
    order, the tail that fills no batch dropped); an integer seed draws
    window starts uniformly from ``np.random.default_rng(seed)``.
    """
    n = len(ds)
    w = seq + 1
    if n < w:
        raise ValueError(f"dataset ({n} tokens) shorter than window {w}")
    if seed is None:
        starts_all = np.arange(0, n - w + 1, w)
        total = len(starts_all) // batch
        if n_batches is not None:
            total = min(total, n_batches)
        for b in range(total):
            s = starts_all[b * batch:(b + 1) * batch]
            yield np.stack([np.asarray(ds.tokens[i:i + w]) for i in s]
                           ).astype(np.int32)
        return
    rng = np.random.default_rng(seed)
    b = 0
    while n_batches is None or b < n_batches:
        s = rng.integers(0, n - w + 1, size=batch)
        yield np.stack([np.asarray(ds.tokens[i:i + w]) for i in s]
                       ).astype(np.int32)
        b += 1


def _map(fn, item):
    """``fn`` over the arrays of a batch (an array, or a tuple, list or
    dict of them)."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)


def prefetch(it: Iterator, size: int = 2, device=None) -> Iterator:
    """Stage ``size`` upcoming batches on ``device`` (``None`` means the
    GPU) while the consumer runs, and yield them as tensors in order.

    A daemon thread pulls from ``it`` (numpy arrays or tensors, or
    tuples, lists and dicts of them) and parks each batch, on the device,
    in a bounded queue. On a CUDA device the copy runs from pinned memory
    on the worker's own stream, overlapping the consumer's step; the
    consumer's current stream waits on the copy's event before the batch
    is yielded. An exception in the source iterator is raised at the
    consumer. Closing or abandoning the generator stops the worker and
    drops the staged batches. The device is checked at the call; the
    worker starts at the first ``next``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # The worker thread needs the card by index: the caller's current.
        dev = torch.device("cuda", torch.cuda.current_device())
    return _prefetch(it, size, dev)


def _prefetch(it: Iterator, size: int, dev: torch.device) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=size)
    END, ERR = object(), object()
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(side):
        def to_device(a):
            t = torch.as_tensor(a)
            if side is None:
                return t.to(dev)
            with torch.cuda.stream(side):
                return t.pin_memory().to(dev, non_blocking=True)
        return to_device

    def worker():
        try:
            side = None
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
                side = torch.cuda.Stream(device=dev)
            for item in it:
                if stop.is_set():
                    return
                item = _map(stage(side), item)
                ready = None
                if side is not None:
                    ready = torch.cuda.Event()
                    ready.record(side)
                if not put((item, ready)):
                    return
            put(END)
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            put((ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if item[0] is ERR:
                raise item[1]
            item, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                _map(lambda a: a.record_stream(consumer), item)
            yield item
    finally:
        # Finished or abandoned (break, exception, GeneratorExit): release
        # the worker and drop the staged batches so their device memory is
        # not held for the life of the process.
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
