"""Axis collectives over the active mesh: the JAX package's
``lax.axis_size``/``axis_index``/``psum``/``pmean``/``all_gather``/
``ppermute``/``all_to_all`` as the train step uses them, and
``parallel/collective.py``'s ring shift, neighbour and halo exchanges,
``all_to_all_seq`` and the ``*_sharded`` wrappers.

A function reads its axis from the mesh made active by ``with mesh:``
(:class:`mpi_acx_torch.parallel.mesh.Mesh`) and runs on the mesh's process
group for this rank's line of that axis. On axes of size 1 each is exactly
the identity (``ppermute`` gives zeros where the permutation sends nothing
to the one rank, as in JAX).

**Autograd.** Each collective is a ``torch.autograd.Function`` whose
backward is the transpose the JAX train step differentiates with under
``shard_map(check_vma=False)``: ``psum`` -> ``psum``, ``pmean`` ->
``pmean``, ``all_gather`` -> reduce-scatter (sum), ``ppermute`` ->
``ppermute`` of the inverted pairs, ``all_to_all`` -> ``all_to_all``. In
an SPMD program every device runs every transpose. Autograd runs a node's
backward only where a gradient reaches it, so ranks whose graphs differ
(a causal ring block skipped, a pipeline stage that scores no loss) would
leave a peer waiting. :func:`tape` closes that gap: while one is open,
every collective takes the tape's leaf as an extra input (so its node
exists even where its input needs no gradient) and records its output;
``tape.sink(loss)`` ties every output to the loss with a zero cotangent.
Every rank then back-propagates through every collective it ran. The
autograd engine runs the nodes of one graph in decreasing order of
creation, so all members of a group issue their backward collectives in
the reverse of the forward's order, which is the same on every member.
``ppermute`` messages also carry a tag made from the forward call's
sequence number on its group, so a message can only match its own pair.

**The wire.** With a NCCL group the tensors travel as they are. A gloo
group takes host tensors: a CUDA tensor is copied to the host and back
explicitly, on the current stream, as the wire of that group. Nothing
falls back to another backend, and a failed collective raises.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

_ACTIVE: list = []
_TAPES: list = []
_SEQ: dict = {}               # (mesh line) -> ppermute calls so far
# Bytes this rank has handed to the wire, by axis tuple: each call's
# payload (all_reduce its buffer, all_gather its block, reduce-scatter its
# whole input, ppermute what it sends, all_to_all its input). Clear it to
# count a span.
WIRE_BYTES: dict = {}
Axes = Union[str, Tuple[str, ...]]
_TAG_SPAN = 1 << 29           # gloo tags are 32-bit


def push_mesh(mesh) -> None:
    _ACTIVE.append(mesh)


def pop_mesh(mesh) -> None:
    if not _ACTIVE or _ACTIVE[-1] is not mesh:
        raise RuntimeError("meshes must be exited in the order entered")
    _ACTIVE.pop()


def _ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


def _axes(axes: Axes, op: str):
    """``(mesh, the axes of ``axes`` larger than 1 in mesh order)``;
    raises unless every axis is on the active mesh."""
    if not _ACTIVE:
        raise RuntimeError(f"{op}: no active mesh (use `with mesh:`)")
    mesh = _ACTIVE[-1]
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for axis in names:
        if axis not in mesh.shape:
            raise NameError(f"{op}: unknown mesh axis {axis!r} (mesh axes "
                            f"{tuple(mesh.shape)})")
    return mesh, tuple(a for a in mesh.shape
                       if a in names and mesh.shape[a] > 1)


def axis_size(axis: str) -> int:
    mesh, _ = _axes(axis, "axis_size")
    return mesh.shape[axis]


def axis_index(axis: str) -> int:
    mesh, _ = _axes(axis, "axis_index")
    return mesh.coords[axis]


# -- the wire --------------------------------------------------------------

def _to_wire(x, group):
    """``x`` as ``group``'s backend takes it: contiguous, and on the host
    for gloo (an explicit copy, ordered after the current stream's
    work)."""
    x = x.detach()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.to("cpu").contiguous()
    return x.contiguous()


def _count(axes, buf) -> None:
    WIRE_BYTES[axes] = WIRE_BYTES.get(axes, 0) + buf.numel() * \
        buf.element_size()


def _from_wire(buf, like):
    return buf.to(like.device) if buf.device != like.device else buf


def _all_reduce(x, mesh, axes, mean):
    group, ranks = mesh.line(axes)
    buf = _to_wire(x, group)
    if buf.data_ptr() == x.data_ptr():      # reduced in place: not x
        buf = buf.clone()
    _count(axes, buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if mean:
        buf = buf / len(ranks)
    return _from_wire(buf, x)


def _gather(x, mesh, axis_name):
    """[n, *x.shape]: every rank's ``x`` in axis order."""
    group, ranks = mesh.line((axis_name,))
    buf = _to_wire(x, group)
    out = buf.new_empty((len(ranks),) + tuple(buf.shape))
    _count((axis_name,), buf)
    dist.all_gather(list(out.unbind(0)), buf, group=group)
    return _from_wire(out, x)


def _scatter_sum(parts, mesh, axis_name):
    """The reduce-scatter of ``parts`` [n, ...]: part ``axis_index`` summed
    over the ranks, by an all_reduce of the whole stack (gloo's own
    reduce-scatter is not in every PyTorch release)."""
    group, _ = mesh.line((axis_name,))
    buf = _to_wire(parts, group)
    if buf.data_ptr() == parts.data_ptr():
        buf = buf.clone()                  # reduced in place: not parts
    _count((axis_name,), buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(buf[mesh.coords[axis_name]], parts)


def _check_perm(perm, n):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation of "
                         f"part of range({n})")


def _exchange(x, mesh, axis_name, perm, tag):
    """This rank's ``x`` to its destinations under ``perm``; what its
    source sent (zeros where none)."""
    group, ranks = mesh.line((axis_name,))
    me = mesh.coords[axis_name]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if src == [me]:
        return x.clone()
    buf = _to_wire(x, group)
    out = torch.zeros_like(buf)
    ops = []
    if dst and dst != [me]:
        _count((axis_name,), buf)
        ops.append(dist.P2POp(dist.isend, buf, ranks[dst[0]], group, tag))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _from_wire(out, x)


def _all_to_all(stacked, mesh, axis_name):
    """[n, ...] -> [n, ...]: part i of the result is part ``axis_index``
    of rank i's input."""
    group, _ = mesh.line((axis_name,))
    buf = _to_wire(stacked, group)
    out = torch.empty_like(buf)
    _count((axis_name,), buf)
    dist.all_to_all_single(out, buf, group=group)
    return _from_wire(out, stacked)


# -- the autograd Functions -------------------------------------------------

class _Psum(torch.autograd.Function):
    """psum (``mean``: pmean) over a tuple of axes; the transpose is
    itself."""

    @staticmethod
    def forward(ctx, x, mesh, axes, mean, *anchor):
        ctx.args, ctx.n_anchor = (mesh, axes, mean), len(anchor)
        return _all_reduce(x, mesh, axes, mean)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, *ctx.args), None, None, None) \
            + (None,) * ctx.n_anchor


class _AllGather(torch.autograd.Function):
    """all_gather along ``axis`` (``tiled``: concatenated, else stacked in
    a new dimension there); the transpose is the summing reduce-scatter
    (JAX's psum_scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, axis, tiled, *anchor):
        ctx.args, ctx.n_anchor = (mesh, axis_name, axis, tiled), len(anchor)
        stacked = _gather(x, mesh, axis_name)         # [n, *x.shape]
        out = stacked.movedim(0, axis)
        if tiled:
            shape = list(x.shape)
            shape[axis] *= stacked.shape[0]
            out = out.reshape(shape)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, axis, tiled = ctx.args
        n = mesh.shape[axis_name]
        if tiled:
            parts = torch.stack(g.chunk(n, dim=axis))
        else:
            parts = g.movedim(axis, 0)
        return (_scatter_sum(parts, mesh, axis_name), None, None, None,
                None) + (None,) * ctx.n_anchor


def _next_tag(mesh, axis_name) -> int:
    """Twice the sequence number of this ppermute call on the line (its
    backward uses the odd tag after it)."""
    key = (id(mesh.line((axis_name,))[0]), axis_name)
    seq = _SEQ.get(key, 0)
    _SEQ[key] = seq + 1
    return 2 * (seq % _TAG_SPAN)


class _Ppermute(torch.autograd.Function):
    """ppermute; the transpose sends the cotangents back along the inverted
    pairs."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, perm, *anchor):
        tag = _next_tag(mesh, axis_name)
        ctx.args, ctx.n_anchor = (mesh, axis_name, perm, tag), len(anchor)
        return _exchange(x, mesh, axis_name, perm, tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis_name, perm, tag = ctx.args
        back = [(d, s) for s, d in perm]
        return (_exchange(g, mesh, axis_name, back, tag + 1), None, None,
                None) + (None,) * ctx.n_anchor


class _AllToAll(torch.autograd.Function):
    """all_to_all over the leading dimension [n, ...]; the transpose is
    itself."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, *anchor):
        ctx.args, ctx.n_anchor = (mesh, axis_name), len(anchor)
        return _all_to_all(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, *ctx.args), None, None) \
            + (None,) * ctx.n_anchor


class _Tie(torch.autograd.Function):
    """``y`` itself, tied to ``outs`` with a zero cotangent for each."""

    @staticmethod
    def forward(ctx, y, *outs):
        ctx.metas = [(o.shape, o.dtype, o.device) for o in outs]
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(
            torch.zeros((), dtype=dt, device=dev).expand(shape)
            for shape, dt, dev in ctx.metas)


class Tape:
    """The collectives of one backward graph (see the module docstring)."""

    def __init__(self, device):
        self.leaf = torch.zeros((), device=device, requires_grad=True)
        self.outs: list = []

    def sink(self, y):
        """``y``, with every collective output recorded so far tied to it
        (back-propagate from the result)."""
        return tie(y, *self.outs)


def tie(y, *deps):
    """``y``, with ``deps`` tied to it by a zero cotangent: back-propagating
    from the result reaches the producers of ``deps`` (their collectives
    run their backward on this rank too) and changes no gradient."""
    return _Tie.apply(y, *deps) if deps else y


@contextlib.contextmanager
def tape(device=None):
    """Open a :class:`Tape` for the collectives run inside the block.
    Close it before the backward: a recompute there (``remat``) runs its
    collectives outside any graph that is back-propagated. On a mesh whose
    axes are all 1 no collective reaches the tape, and its sink is the
    identity."""
    t = Tape(device)
    _TAPES.append(t)
    try:
        yield t
    finally:
        _TAPES.remove(t)


def retain(*tensors) -> None:
    """Put ``tensors`` on the open tape (if any), with the collectives'
    outputs: its sink ties them to the loss too. Nested tuples (a MoE
    layer's ``(h, (balance, z))``) are flattened."""
    if not (_TAPES and torch.is_grad_enabled()):
        return
    for t in tensors:
        if isinstance(t, tuple):
            retain(*t)
        elif t.requires_grad:
            _TAPES[-1].outs.append(t)


def _apply(fn, x, *args):
    if _TAPES and torch.is_grad_enabled():
        t = _TAPES[-1]
        out = fn.apply(x, *args, t.leaf)
        t.outs.append(out)
        return out
    return fn.apply(x, *args)


# -- the collectives --------------------------------------------------------

def psum(x, axes: Axes):
    mesh, big = _axes(axes, "psum")
    return _apply(_Psum, x, mesh, big, False) if big else x


def pmean(x, axes: Axes):
    mesh, big = _axes(axes, "pmean")
    return _apply(_Psum, x, mesh, big, True) if big else x


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Gather over the mesh axis: ``tiled`` concatenates along ``axis``,
    else stacks in a new dimension there."""
    mesh, big = _axes(axis_name, "all_gather")
    if not big:
        return x if tiled else x.unsqueeze(axis)
    return _apply(_AllGather, x, mesh, axis_name, axis % (x.dim() + (
        0 if tiled else 1)), tiled)


def ppermute(x, axis_name: str, perm: Sequence[tuple[int, int]]):
    """Send this rank's ``x`` along the (source, destination) pairs of
    ``perm``; a rank that receives nothing gets zeros."""
    mesh, big = _axes(axis_name, "ppermute")
    perm = [tuple(p) for p in perm]
    _check_perm(perm, mesh.shape[axis_name])
    if not big:
        return x if perm else torch.zeros_like(x)
    return _apply(_Ppermute, x, mesh, axis_name, perm)


def all_to_all(x, axis_name: str):
    """``lax.all_to_all(x, axis_name, 0, 0, tiled=False)``: x [n, ...];
    part i of the result is what rank i held at part ``axis_index``."""
    mesh, big = _axes(axis_name, "all_to_all")
    if x.shape[0] != mesh.shape[axis_name]:
        raise ValueError(f"all_to_all: leading dimension {x.shape[0]} is not "
                         f"the axis size {mesh.shape[axis_name]}")
    return _apply(_AllToAll, x, mesh, axis_name) if big else x


# -- parallel/collective.py ---------------------------------------------------

def ring_shift(x, axis_name: str, shift: int = 1):
    """Rotate shards around the ring: each rank sends its shard ``shift``
    steps to the right and receives from the left."""
    return ppermute(x, axis_name, _ring_perm(axis_size(axis_name), shift))


def neighbor_exchange(right_going, left_going, axis_name: str):
    """Bidirectional neighbour exchange: ``(from_left, from_right)``."""
    n = axis_size(axis_name)
    return (ppermute(right_going, axis_name, _ring_perm(n, 1)),
            ppermute(left_going, axis_name, _ring_perm(n, -1)))


def halo_exchange_1d(x, axis_name: str, halo: int):
    """Periodic 1-D halo exchange: the shard ``x`` (leading axis) padded
    with ``halo`` rows from each ring neighbour."""
    from_left, from_right = neighbor_exchange(x[-halo:], x[:halo],
                                              axis_name)
    return torch.cat([from_left, x, from_right], dim=0)


def halo_exchange_2d(x, row_axis: str, col_axis: str, halo: int):
    """Periodic 2-D halo exchange of the local [H, W] block: rows first,
    then the columns of the padded block, so the corners carry the
    diagonal neighbours' corners. Returns [H + 2h, W + 2h]."""
    x = halo_exchange_1d(x, row_axis, halo)
    from_left, from_right = neighbor_exchange(x[:, -halo:], x[:, :halo],
                                              col_axis)
    return torch.cat([from_left, x, from_right], dim=1)


def all_to_all_seq(x, axis_name: str, split_axis: int, concat_axis: int):
    """All-to-all reshard (the Ulysses primitive): split ``x`` into n parts
    along ``split_axis``, send part i to rank i, and concatenate what
    arrives along ``concat_axis``."""
    n = axis_size(axis_name)
    swapped = all_to_all(torch.stack(x.chunk(n, dim=split_axis)), axis_name)
    return torch.cat(swapped.unbind(0), dim=concat_axis)


def _on(mesh, fn, *args, **kw):
    with mesh:
        return fn(*args, **kw)


def ring_shift_sharded(arr, mesh, axis_name: str = "x", shift: int = 1):
    """The JAX wrapper's per-rank meaning: ``arr`` is this rank's shard
    (its block of the array sharded on the leading dim over
    ``axis_name``), moved ``shift`` ring steps; returns the shard that
    arrives."""
    return _on(mesh, ring_shift, arr, axis_name, shift)


def halo_exchange_1d_sharded(arr, mesh, halo: int, axis_name: str = "x"):
    """The JAX wrapper's per-rank meaning: ``arr`` is this rank's shard;
    returns its padded block with a leading shard axis of 1 ([1, shard + 2
    * halo, ...]), as the JAX out-spec gives each device."""
    return _on(mesh, halo_exchange_1d, arr, axis_name, halo)[None]

