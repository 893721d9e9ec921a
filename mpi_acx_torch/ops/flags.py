"""Device-side partition signalling: the flag kernels B1-B5 and their plain
versions.

A running kernel takes part in the partitioned state machine through two
operations of the reference: ``MPIX_Pready(p, req)`` stores PENDING into
partition ``p``'s flag word, and ``MPIX_Parrived(req, p, &flag)`` reads it
as true iff COMPLETED. Here the flag table is an int32 tensor ``[n]`` on the
card, one word per partition, holding the protocol states of the native
runtime (``include/acx/state.h``), so a table produced here is mirrored
word for word into the table the native proxy polls
(``Runtime.publish_partition_flags``) and back (``fetch_partition_flags``).

The kernels (``csrc/flags.cu``) replace the Pallas kernels of the JAX
package's ``ops/flags.py``: :func:`pready` (B1), :func:`pready_many` (B2),
:func:`parrived` (B3), :func:`parrived_all` (B4) and
:func:`produce_and_pready` (B5). Each public function keeps the JAX name
and arguments. On a CUDA tensor it launches its kernel or raises, and adds
one to its ``launches`` count; on a CPU tensor it runs its plain version
(``*_reference``), which is also what the kernels are held to on the card.

Mutators update the table **in place** and return it (the JAX functions
alias it, ``input_output_aliases``). An index is a Python int or a 0-d
int32 tensor on the table's device, which the kernel reads from device
memory, so the caller never syncs. As in the TPU kernels, which select over
the padded table: marking an index outside ``[0, n)`` changes nothing,
polling one reads 0, ``parrived_all`` of no index is 1, and repeated
indices are harmless.

The deadlock rule of the reference is kept by construction: ``pready*`` and
``parrived*`` are separate kernels, and ``parrived*`` is a poll that never
waits on the device.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_acx_torch.ops import _build

# Op states: the wire protocol shared with the native runtime
# (include/acx/state.h).
AVAILABLE = 0
RESERVED = 1
PENDING = 2
ISSUED = 3
COMPLETED = 4
CLEANUP = 5

_INT32 = (-2 ** 31, 2 ** 31)


class Identity:
    """The producer ``t -> t`` (a new tensor), compiled into B5."""

    code = 0

    def __call__(self, t):
        return t.clone()


class Affine:
    """The producer ``t -> t * a + b``, compiled into B5. Rounded after the
    product and after the sum, as the plain expression is; the JAX workers'
    ``lambda t: t * 2.0 + 1.0`` is ``Affine(2.0, 1.0)``."""

    code = 1

    def __init__(self, a: float, b: float):
        self.a, self.b = float(a), float(b)

    def __call__(self, t):
        return t * self.a + self.b


identity = Identity()


# --- plain versions ----------------------------------------------------------

def _match(flags, idxs):
    """[k, n] bool: index i names slot j (the TPU kernels' compare of linear
    slot ids with the index). A Python int is compared as a scalar, so no
    host-to-device copy is made for it."""
    lin = torch.arange(flags.shape[0], device=flags.device, dtype=torch.int64)
    if isinstance(idxs, int):
        return (lin == idxs)[None, :]
    if not isinstance(idxs, torch.Tensor):
        idxs = torch.as_tensor(idxs, dtype=torch.int64)
    idxs = idxs.to(device=flags.device, dtype=torch.int64)
    return lin[None, :] == idxs.reshape(-1, 1)


def pready_reference(flags, idx):
    """Plain B1: PENDING at slot ``idx``, in place; returns ``flags``."""
    return flags.masked_fill_(_match(flags, idx).any(0), PENDING)


def pready_many_reference(flags, idxs):
    """Plain B2: PENDING at every slot of ``idxs``, in place."""
    return flags.masked_fill_(_match(flags, idxs).any(0), PENDING)


def _words(flags, idxs):
    """Word of each index (0 outside the table), as the TPU kernels read
    it: the sum over the table of the words whose slot id equals it."""
    return torch.where(_match(flags, idxs), flags[None, :], 0).sum(1)


def parrived_reference(flags, idx):
    """Plain B3: 0-d int32, 1 iff slot ``idx`` is COMPLETED."""
    return (_words(flags, idx)[0] == COMPLETED).to(torch.int32)


def parrived_all_reference(flags, idxs):
    """Plain B4: 0-d int32, 1 iff every slot of ``idxs`` is COMPLETED."""
    return (_words(flags, idxs) == COMPLETED).all().to(torch.int32)


def produce_and_pready_reference(produce, x, flags, idx):
    """Plain B5: ``(produce(x), flags)`` with PENDING at ``idx``, in
    place."""
    payload = produce(x)
    return payload, pready_reference(flags, idx)


# --- kernels -----------------------------------------------------------------

def _check_table(flags, name):
    if flags.dtype != torch.int32 or flags.ndim != 1:
        raise TypeError(f"{name}: the flag table is int32 [n], got "
                        f"{flags.dtype} {tuple(flags.shape)}")
    if flags.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {flags.device}")
    if not flags.is_contiguous():
        raise ValueError(f"{name}: the flag table must be contiguous")


def _one_index(flags, idx, name):
    """(device pointer or None, by-value index) for a single index."""
    if isinstance(idx, torch.Tensor):
        if idx.device != flags.device or idx.dtype != torch.int32 \
                or idx.numel() != 1:
            raise ValueError(f"{name}: a tensor index is one int32 value on "
                             f"{flags.device}, got {idx.dtype} "
                             f"{tuple(idx.shape)} on {idx.device}")
        return ctypes.c_void_p(idx.data_ptr()), 0
    idx = int(idx)
    if not _INT32[0] <= idx < _INT32[1]:
        idx = -1                   # outside any table: changes nothing
    return None, idx


def _index_list(flags, idxs, name):
    """An int32 index tensor on the table's device (a list or a CPU tensor
    is copied there)."""
    if not isinstance(idxs, torch.Tensor):
        idxs = torch.as_tensor(idxs, dtype=torch.int64)
    if idxs.device != flags.device or idxs.dtype != torch.int32:
        if idxs.numel() and not (_INT32[0] <= int(idxs.min())
                                 and int(idxs.max()) < _INT32[1]):
            raise ValueError(f"{name}: index outside int32")
        idxs = idxs.to(device=flags.device, dtype=torch.int32)
    return idxs.reshape(-1).contiguous()


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def pready(flags, idx):
    """B1: mark slot ``idx`` PENDING from device code (``MPIX_Pready``).
    Updates ``flags`` in place and returns it."""
    if flags.device.type == "cpu":
        return pready_reference(flags, idx)
    _check_table(flags, "pready")
    ptr, val = _one_index(flags, idx, "pready")
    _check_rc(_build.lib().acx_flags_pready(
        flags.data_ptr(), flags.shape[0], ptr, val, 1,
        _build.stream_handle(flags.device)), "pready")
    pready.launches += 1
    return flags


def pready_many(flags, idxs):
    """B2: mark every slot of ``idxs`` PENDING in one kernel (the
    ``mark_ready<<<1,N>>>`` launch of the reference's ring-partitioned
    example). Updates ``flags`` in place and returns it. An empty list
    launches nothing."""
    if flags.device.type == "cpu":
        return pready_many_reference(flags, idxs)
    _check_table(flags, "pready_many")
    idxs = _index_list(flags, idxs, "pready_many")
    if idxs.numel() == 0:
        return flags
    _check_rc(_build.lib().acx_flags_pready(
        flags.data_ptr(), flags.shape[0], idxs.data_ptr(), 0, idxs.numel(),
        _build.stream_handle(flags.device)), "pready_many")
    pready_many.launches += 1
    return flags


def parrived(flags, idx):
    """B3: non-blocking poll, is slot ``idx`` COMPLETED? Returns a 0-d int32
    tensor (0/1) on the table's device (``MPIX_Parrived``)."""
    if flags.device.type == "cpu":
        return parrived_reference(flags, idx)
    _check_table(flags, "parrived")
    ptr, val = _one_index(flags, idx, "parrived")
    out = torch.empty((), dtype=torch.int32, device=flags.device)
    _check_rc(_build.lib().acx_flags_parrived(
        flags.data_ptr(), flags.shape[0], ptr, val, 1, out.data_ptr(),
        _build.stream_handle(flags.device)), "parrived")
    parrived.launches += 1
    return out


def parrived_all(flags, idxs):
    """B4: poll a set of slots; a 0-d int32 tensor, 1 iff every one is
    COMPLETED (1 for no slot). The condition the reference's
    ``wait_until_arrived`` spins on, exposed as a poll: no kernel here ever
    waits on a flag."""
    if flags.device.type == "cpu":
        return parrived_all_reference(flags, idxs)
    _check_table(flags, "parrived_all")
    idxs = _index_list(flags, idxs, "parrived_all")
    out = torch.empty((), dtype=torch.int32, device=flags.device)
    _check_rc(_build.lib().acx_flags_parrived(
        flags.data_ptr(), flags.shape[0], idxs.data_ptr(), 0, idxs.numel(),
        out.data_ptr(), _build.stream_handle(flags.device)), "parrived_all")
    parrived_all.launches += 1
    return out


_done_counters = {}     # (device index, stream) -> B5's finished-block count


def _done_counter(device) -> torch.Tensor:
    """B5's block counter for the current stream: zeroed once, then reset
    by every launch's last block, so launches on one stream share it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _done_counters:
        _done_counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _done_counters[key]


def produce_and_pready(produce, x, flags, idx):
    """B5: a partition's payload ``produce(x)`` and slot ``idx`` marked
    PENDING, readiness published behind the data. Returns ``(payload,
    flags)``; ``flags`` is updated in place.

    ``produce`` is any shape-preserving callable, as in the JAX kernel. On
    the card :data:`identity` and :class:`Affine` producers are compiled
    into the fused B5 kernel (``x`` a contiguous float32 tensor), whose
    flag word is stored only after every block's payload stores are
    visible. Any other callable runs as the caller's PyTorch code on the
    current stream, as JAX traces the caller's ``produce`` into its
    kernel, and the flag store is B1's kernel launched on the same stream
    behind it (counted in ``pready.launches``): a reader that sees PENDING
    sees the payload. On a CPU tensor this is the plain version."""
    if x.device.type == "cpu" and flags.device.type == "cpu":
        return produce_and_pready_reference(produce, x, flags, idx)
    _check_table(flags, "produce_and_pready")
    if x.device != flags.device:
        raise ValueError(f"produce_and_pready: x on {x.device}, the flag "
                         f"table on {flags.device}")
    if not isinstance(produce, (Identity, Affine)):
        payload = produce(x)
        if not isinstance(payload, torch.Tensor) or payload.shape != x.shape:
            raise ValueError(f"produce_and_pready: {produce!r} must keep "
                             f"x's shape {tuple(x.shape)}")
        return payload, pready(flags, idx)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"produce_and_pready: the fused kernel takes a "
                         f"non-empty contiguous float32 x, got {x.dtype} "
                         f"{tuple(x.shape)}")
    ptr, val = _one_index(flags, idx, "produce_and_pready")
    payload = torch.empty_like(x)
    a, b = (produce.a, produce.b) if isinstance(produce, Affine) else (1, 0)
    _check_rc(_build.lib().acx_flags_produce_and_pready(
        x.data_ptr(), payload.data_ptr(), x.numel(), produce.code, a, b,
        flags.data_ptr(), flags.shape[0], ptr, val,
        _done_counter(x.device).data_ptr(),
        _build.stream_handle(x.device)), "produce_and_pready")
    produce_and_pready.launches += 1
    return payload, flags


for _fn in (pready, pready_many, parrived, parrived_all, produce_and_pready):
    _fn.launches = 0
del _fn


def select_flags(use_kernels):
    """The kernel switch (shaped like ``select_attention``): ``False`` -> the
    plain versions on any device; ``True`` or ``None`` -> the wrappers,
    which launch the kernels for a CUDA table and run the plain versions for
    a CPU one. Returns ``(pready, pready_many, parrived, parrived_all,
    produce_and_pready)``."""
    if use_kernels is False:
        return (pready_reference, pready_many_reference, parrived_reference,
                parrived_all_reference, produce_and_pready_reference)
    return (pready, pready_many, parrived, parrived_all, produce_and_pready)
