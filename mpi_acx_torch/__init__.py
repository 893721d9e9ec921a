"""mpi_acx_torch — the PyTorch and CUDA port of mpi_acx_tpu.

A second package beside the JAX one, held against it by the tests in
``tests/test_torch_*.py``. Ported so far: the continuous-batching serving
path (the GPT-2 family in :mod:`mpi_acx_torch.models`, its decode scaffold
and scheduler, and the two attention kernels it runs on the GPU), and the
device-triggered exchange (:mod:`mpi_acx_torch.runtime`, a ctypes binding
over the native host plane; :mod:`mpi_acx_torch.triggers`, stream-ordered
triggers; and the flag kernels in :mod:`mpi_acx_torch.ops.flags`), and
training through the framework's train step on a dp x pp x tp mesh of
ranks (:mod:`mpi_acx_torch.train` over :mod:`mpi_acx_torch.parallel`:
process groups and collectives over ``torch.distributed``, with the
row-logsumexp flash kernel and its backward; GPipe, interleaved and 1F1B
schedules, remat, the int8 dp sync), fed by :mod:`mpi_acx_torch.data`,
checkpointed by :mod:`mpi_acx_torch.checkpoint` and timed by
:mod:`mpi_acx_torch.profiling`. The kernels are written by hand for
Hopper (:mod:`mpi_acx_torch.ops`, sources in ``csrc/``). It imports
nothing of JAX or of ``mpi_acx_tpu``.

Importing the package loads no submodule and does not initialise CUDA.
"""

from mpi_acx_torch.version import __version__  # noqa: F401

_SUBMODULES = ("checkpoint", "data", "device", "models", "ops", "parallel",
               "profiling", "reqlog", "runtime", "train", "triggers")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"mpi_acx_torch.{name}")
    raise AttributeError(f"module 'mpi_acx_torch' has no attribute '{name}'")
