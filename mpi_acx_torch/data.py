"""Token data for training (the JAX package's ``data.py``): not ported
yet. Every name of that module raises ``NotImplementedError`` here;
``chip_smoke.py`` trains on a synthetic task made on the card."""

_NAMES = ("TokenDataset", "batches", "prefetch")


def __getattr__(name):
    if name in _NAMES:
        raise NotImplementedError(
            f"mpi_acx_torch.data.{name} is not ported yet (ROADMAP.md §A, "
            f"'data.py and checkpoint.py')")
    raise AttributeError(f"module 'mpi_acx_torch.data' has no attribute "
                         f"'{name}'")
