"""Checkpoints of parameters and optimizer state (the JAX package's
Orbax-backed ``checkpoint.py``): not ported yet. Every name of that
module raises ``NotImplementedError`` here."""

_NAMES = ("Checkpointer", "warm_start")


def __getattr__(name):
    if name in _NAMES:
        raise NotImplementedError(
            f"mpi_acx_torch.checkpoint.{name} is not ported yet (ROADMAP.md "
            f"§A, 'data.py and checkpoint.py')")
    raise AttributeError(f"module 'mpi_acx_torch.checkpoint' has no "
                         f"attribute '{name}'")
