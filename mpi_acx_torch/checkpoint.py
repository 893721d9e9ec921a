"""Checkpoint and resume of training state (the JAX package's
``checkpoint.py``).

The format is **not Orbax's**: each step is one directory ``<step>/``
under the checkpoint directory holding ``state.pt``, written by
``torch.save`` into a temporary directory and renamed into place, so a
write cut short never looks like a step. A state is any nesting of
dicts, lists and tuples over tensors and plain Python values: the
parameters, and ``optimizer.state_dict()`` (whose keys are ints). A
restored state is bit-equal to the saved one, so a resumed run replays
the original trajectory step for step.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _to_host(x):
    """A copy of ``x`` with every tensor copied to the CPU (a CPU tensor
    is copied too, so the caller may update it in place afterwards)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _place(saved, like, path="state"):
    """``saved`` with each tensor on its counterpart's device and in its
    dtype (the shapes must agree); a tensor with no counterpart in
    ``like`` stays as saved."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise ValueError(f"{path}: checkpoint holds {got}, like holds "
                             f"{tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(saved, torch.Tensor):
        return saved
    if isinstance(saved, dict):
        like = like if isinstance(like, dict) else {}
        missing = set(like) - set(saved)
        if missing:
            raise ValueError(f"{path}: checkpoint lacks {sorted(missing)}")
        return {k: _place(v, like.get(k), f"{path}[{k!r}]")
                for k, v in saved.items()}
    if isinstance(saved, (tuple, list)):
        like = like if isinstance(like, (tuple, list)) else ()
        if like and len(like) != len(saved):
            raise ValueError(f"{path}: checkpoint holds {len(saved)} "
                             f"entries, like holds {len(like)}")
        return type(saved)(
            _place(v, like[i] if like else None, f"{path}[{i}]")
            for i, v in enumerate(saved))
    return saved


class Checkpointer:
    """Step-indexed checkpoint directory with retention.

    >>> ckpt = Checkpointer("/tmp/run1", max_to_keep=3)
    >>> ckpt.save(step, {"params": params, "opt": opt.state_dict()})
    >>> state = ckpt.restore(like={"params": params0,
    ...                            "opt": opt0.state_dict()})

    Only the ``max_to_keep`` newest steps are kept. As with the JAX
    package's Orbax manager, a step at or below the newest saved step is
    not written.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _write(self, step: int, host) -> None:
        tmp = os.path.join(self._dir, f".tmp-{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._max:
            for old in self.all_steps()[:-self._max]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write_in_background(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 — raised by the waiter
            self._error = e

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Write ``state`` for ``step``. The state is copied off the
        device on the calling thread, so the caller may update it in place
        once this returns. ``wait=False`` leaves the file write to a
        background thread (call :meth:`wait_until_finished` or
        :meth:`close` before reading the step or exiting)."""
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return
        host = _to_host(state)
        if wait:
            self._write(step, host)
            return
        self._writer = threading.Thread(target=self._write_in_background,
                                        args=(step, host), daemon=True)
        self._writer.start()

    def restore(self, step: Optional[int] = None,
                like: Optional[Any] = None) -> Any:
        """Read a step (default: the latest). Tensors come back on the
        CPU in their saved dtypes, except that with ``like`` each tensor
        that has a counterpart there lands on that tensor's device and in
        its dtype (a fresh optimizer's ``state_dict()`` holds no moments
        yet: ``optimizer.load_state_dict`` places them by its
        parameters). Raises ``FileNotFoundError`` when there is no
        checkpoint."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        path = os.path.join(self._step_dir(step), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self._dir}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if like is None:
            return saved
        return _place(saved, like)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """The complete steps in the directory, ascending (a temporary
        directory of a write in progress or cut short is not one)."""
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self._dir, name, STATE_FILE)))

    def wait_until_finished(self) -> None:
        """Wait for a background write; raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def warm_start(directory: str, like: Any,
               step: Optional[int] = None):
    """Restore the latest step (or ``step``) of ``directory`` into
    ``like``'s devices and dtypes for a rank that joins a running job, and
    return ``(state, step)``; ``(None, None)`` when the directory holds no
    checkpoint yet (the joiner keeps its freshly built state).

    >>> state, step = warm_start(ckpt_dir, like=init_state)
    >>> if state is None: state = init_state
    """
    ckpt = Checkpointer(directory)
    try:
        if step is None:
            step = ckpt.latest_step()
        if step is None:
            return None, None
        return ckpt.restore(step, like=like), step
    finally:
        ckpt.close()
