"""Pipeline parallelism over a 'pp' mesh axis (the JAX package's
``parallel/pipeline.py``): the GPipe schedule, its interleaved form, and
the memory-bounded 1F1B schedule.

* :func:`pipeline_forward` — GPipe: T = n_micro + n_stages - 1 ticks;
  stage s computes microbatch m at tick t = s + m, and activations travel
  stage -> stage + 1 by ``ppermute``. Autograd through the tick loop gives
  the backward pipeline.
* :func:`pipeline_forward_interleaved` — the Megatron-LM interleaved
  forward: each device holds ``n_virtual`` chunks, and the bubble shrinks
  by that factor.
* :func:`pipeline_1f1b_loss_and_grads` over :func:`_pipeline_1f1b_engine`
  — 1F1B: one slot loop that runs each device's forward and backward
  units by a static timetable (:func:`_sched_1f1b_tables`, replay-checked
  when built). Autograd never crosses the slot loop: a forward slot runs
  under ``no_grad`` and banks only the stage input, and the backward slot
  re-runs the chunk from that input with autograd on and back-propagates
  the banked cotangent. So the activations alive are the banked inputs,
  O(n_virtual * pp) microbatches, flat in n_micro.

Each stage is a rank of the mesh's 'pp' axis, and ``ppermute`` moves the
activations (and, in the backward, their cotangents) between the stages'
processes. On a one-stage mesh there is no bubble, and each ``ppermute``
is the identity or gives zeros.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mpi_acx_torch.parallel.collective import (axis_index, axis_size,
                                               ppermute, psum, tape)


def _tree(fn, tree):
    """``fn`` over the tensors of a (nested) dict."""
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _first(tree):
    """Drop the leading stage axis of every tensor in a (nested) dict."""
    return _tree(lambda v: v[0], tree)


def pipeline_forward(stage_fn: Callable, stage_params, xs, axis_name: str,
                     with_aux: bool = False):
    """Runs ``xs`` ([n_micro, micro_batch, ...]) through the pipeline and
    returns the last stage's outputs [n_micro, micro_batch, ...] on every
    stage (by psum).

    ``stage_params`` holds this stage's parameters under a leading stage
    axis of 1 (dropped here). ``stage_fn(params, x) -> y`` with
    ``y.shape == x.shape``.

    ``with_aux=True``: ``stage_fn`` returns ``(y, aux)``, aux a tuple of f32
    scalars (the MoE router losses), and the function returns ``(ys,
    aux_sum)``: this stage's aux summed over its valid ticks only, once
    per (layer of the stage, microbatch). Aux never travels between
    stages; the caller psums it over the axis."""
    n_stages = axis_size(axis_name)
    stage = axis_index(axis_name)
    n_micro = xs.shape[0]
    params = _first(stage_params)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]  # no wraparound

    from_left = torch.zeros_like(xs[0])
    ys, aux_sum = [], None
    for t in range(n_micro + n_stages - 1):
        x = xs[min(t, n_micro - 1)] if stage == 0 else from_left
        y = stage_fn(params, x)
        if with_aux:
            y, aux = y
            # Stage s computes microbatch t - s at tick t; the other ticks
            # are the bubble.
            if 0 <= t - stage < n_micro:
                aux_sum = aux if aux_sum is None else tuple(
                    a + b for a, b in zip(aux_sum, aux))
        from_left = ppermute(y, axis_name, fwd_perm)
        ys.append(y)
    # The last stage's valid outputs are those of ticks [n_stages-1, T).
    tail = torch.stack(ys[n_stages - 1:])
    contrib = tail if stage == n_stages - 1 else torch.zeros_like(tail)
    out = psum(contrib, axis_name)
    return (out, aux_sum) if with_aux else out


def pipeline_forward_interleaved(stage_fn: Callable, stage_params, xs,
                                 axis_name: str, n_virtual: int,
                                 with_aux: bool = False):
    """The interleaved virtual-stage pipeline (the Megatron-LM
    interleaved schedule's forward): device s holds ``v = n_virtual``
    chunks, chunk j being global stage ``j * pp + s``. A slot is one
    chunk application per device; microbatches flow in groups of ``pp``
    through chunk 0, then the same group through chunk 1, and so on, so
    the forward takes ``v * n_micro + pp - 1`` slots of which ``pp - 1``
    are fill and drain.

    ``stage_params``' leading axes are [1, n_virtual, ...] (this stage's,
    from :func:`models.transformer.stage_slice_interleaved`); ``xs`` is
    [n_micro, micro_batch, ...] with ``n_micro % pp == 0``. Returns the
    last global stage's outputs on every stage.

    Device s at slot t computes, with u = t - s, b = u // pp: chunk
    j = b % v of microbatch m = (b // v) * pp + u % pp. Every hop (s ->
    s + 1 in the same chunk, pp - 1 -> 0 into the next one) is consumed
    one slot after it is made, so one activation travels. Microbatch m's
    output leaves chunk v - 1 of the last device at slot
    (v * (m // pp) + v - 1) * pp + m % pp + pp - 1, where it is collected.

    ``with_aux=True`` follows :func:`pipeline_forward`'s contract, the
    aux summed over this device's valid slots (each of its v chunks on
    each microbatch once)."""
    n_stages = axis_size(axis_name)
    stage = axis_index(axis_name)
    v = n_virtual
    n_micro = xs.shape[0]
    if n_micro % n_stages != 0:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) % pp "
            f"({n_stages}) == 0")
    ticks = v * n_micro + n_stages - 1
    params = _first(stage_params)                       # [v, per, ...]
    # One circular permute per slot: s -> s+1 is the same-chunk hop and
    # pp-1 -> 0 the wrap that advances to the next chunk.
    ring_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    slot_to_m = [-1] * ticks
    for m in range(n_micro):
        tau = ((v * (m // n_stages) + v - 1) * n_stages + m % n_stages
               + n_stages - 1)
        slot_to_m[tau] = m

    buf = torch.zeros_like(xs[0])
    outs, aux_sum = [None] * n_micro, None
    for t in range(ticks):
        u = max(t - stage, 0)
        b = u // n_stages
        j = b % v
        m = min((b // v) * n_stages + u % n_stages, n_micro - 1)
        # Device 0 starts a chunk-0 slot from a fresh microbatch; every
        # other slot consumes the activation routed to it last slot.
        x = xs[m] if stage == 0 and j == 0 else buf
        y = stage_fn(_tree(lambda q: q[j], params), x)
        if with_aux:
            y, aux = y
            if 0 <= t - stage < v * n_micro:
                aux_sum = aux if aux_sum is None else tuple(
                    a + c for a, c in zip(aux_sum, aux))
        if slot_to_m[t] >= 0 and stage == n_stages - 1:
            outs[slot_to_m[t]] = y
        buf = ppermute(y, axis_name, ring_perm)
    acc = torch.stack([o if o is not None else torch.zeros_like(xs[0])
                       for o in outs])
    out = psum(acc, axis_name)
    return (out, aux_sum) if with_aux else out


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params, xs,
                  targets, axis_name: str):
    """``loss_fn(ys, targets)`` of the pipeline's outputs (autograd
    through it gives the backward schedule)."""
    ys = pipeline_forward(stage_fn, stage_params, xs, axis_name)
    return loss_fn(ys, targets)


# -- 1F1B: the memory-bounded schedule --------------------------------------


class _Sched1F1B:
    """Static (interleaved) 1F1B timetable: numpy tables indexed
    [device, slot], built by :func:`_sched_1f1b_tables` and verified by
    replay before use. Every entry is -1 where no op or arrival happens.

    * ``f_m, f_j, f_cell``: microbatch, chunk and input-buffer cell of the
      forward this device runs at each slot.
    * ``a_cell``: the input-buffer cell into which this slot's incoming
      activation (the forward ring message) is banked.
    * ``b_m, b_j, b_cell``: the backward op (its input cell is the
      forward's, read again to re-run the chunk).
    * ``d_arr, d_use``: the dx-buffer cell into which this slot's incoming
      cotangent (the backward ring message) is banked, and from which
      this slot's backward seeds (-1 at the global last stage, which
      seeds from the loss in the slot).
    * ``K, D``: input and dx buffer depths (interval-colored; K is
      O(V * P), independent of the microbatch count).
    * ``T``: total slots.
    """

    def __init__(self, P, V, T, K, D, f_m, f_j, f_cell, a_cell,
                 b_m, b_j, b_cell, d_arr, d_use):
        self.P, self.V, self.T, self.K, self.D = P, V, T, K, D
        self.f_m, self.f_j, self.f_cell = f_m, f_j, f_cell
        self.a_cell = a_cell
        self.b_m, self.b_j, self.b_cell = b_m, b_j, b_cell
        self.d_arr, self.d_use = d_arr, d_use


def _sched_1f1b_tables(P: int, M: int, V: int = 1) -> _Sched1F1B:
    """Builds the (interleaved) 1F1B timetable by greedy simulation.

    Device s owns chunks j = 0..V-1, chunk j being global stage
    ``j*P + s`` of a V*P-deep virtual pipeline (the Megatron-LM
    interleaved mapping). Each device executes its units in the standard
    1F1B order — warm-up forwards, then strict forward/backward
    alternation, then cool-down backwards — with the interleaved unit
    sequence: the k-th forward is (chunk (k//P) % V, microbatch
    (k//(P*V))*P + k%P) and the k-th backward mirrors it with the chunks
    reversed. The timetable is the unique greedy slot assignment: at
    every slot each device runs its next unit iff its data dependency has
    arrived (one slot per ring hop), else idles.

    Every device is busy 2*M*V slots and the schedule ends at
    T = 2*M*V + 2*(P-1) (asserted). V = 1 reproduces the classic
    non-interleaved timetable (asserted against :func:`_schedule_1f1b`).
    V > 1 requires ``M % P == 0`` (the Megatron constraint).

    A symbolic replay of the tables (:func:`_replay_check`) checks every
    structural invariant when they are built: one op per device and slot,
    every unit scheduled once, producer before consumer with the one-slot
    hop, and no live buffer cell overwritten.
    """
    VP = V * P
    if V > 1 and M % P != 0:
        raise ValueError(
            f"interleaved 1F1B needs n_micro ({M}) % pp ({P}) == 0")
    total = M * V

    def f_unit(k):   # k-th forward on a device -> (m, j)
        return (k // (P * V)) * P + k % P, (k // P) % V

    def b_unit(k):   # k-th backward: chunks in reverse order
        return (k // (P * V)) * P + k % P, V - 1 - (k // P) % V

    def device_order(s):
        if V == 1:
            warm = min(total, P - 1 - s)
        else:
            warm = min(total, (V - 1) * P + 2 * (P - 1 - s))
        seq = [("f",) + f_unit(k) for k in range(warm)]
        fi, bi = warm, 0
        while fi < total:
            seq.append(("f",) + f_unit(fi))
            seq.append(("b",) + b_unit(bi))
            fi, bi = fi + 1, bi + 1
        seq.extend(("b",) + b_unit(k) for k in range(bi, total))
        return seq

    orders = [device_order(s) for s in range(P)]
    ptr = [0] * P
    fs, bs = {}, {}          # (g, m) -> completion slot
    t = 0
    guard = 4 * (VP + total) + 16
    while any(ptr[s] < len(orders[s]) for s in range(P)):
        assert t < guard, f"1F1B schedule deadlock at P={P} M={M} V={V}"
        for s in range(P):
            if ptr[s] >= len(orders[s]):
                continue
            kind, m, j = orders[s][ptr[s]]
            g = j * P + s
            if kind == "f":
                ready = g == 0 or (g - 1, m) in fs and fs[(g - 1, m)] + 1 <= t
                if ready:
                    fs[(g, m)] = t
                    ptr[s] += 1
            else:
                if g == VP - 1:
                    ready = (g, m) in fs and fs[(g, m)] + 1 <= t
                else:
                    ready = (g + 1, m) in bs and bs[(g + 1, m)] + 1 <= t
                if ready:
                    bs[(g, m)] = t
                    ptr[s] += 1
        t += 1
    T = t
    assert T == 2 * total + 2 * (P - 1), (P, M, V, T)

    if V == 1:
        # The greedy simulation must reproduce the closed form, the
        # executable spec of the classic timetable.
        _, fwd_cf, bwd_cf, _, _ = _schedule_1f1b(P, M)
        for s in range(P):
            for m in range(M):
                assert fwd_cf[s][fs[(s, m)]] == m, (P, M, s, m)
                assert bwd_cf[s][bs[(s, m)]] == m, (P, M, s, m)

    # Interval-color the buffer cells of each device. A cell read (its
    # death) at slot t is free for a new banking at t + 1: the slot banks
    # arrivals before the backward reads, so reusing it in the same slot
    # would overwrite a live value.
    def color(intervals):
        """intervals: {unit: (birth, death)} -> ({unit: cell}, depth)."""
        cells = {}
        free, used_until = [], {}
        depth = 0
        for u, (b, d) in sorted(intervals.items(), key=lambda kv: kv[1]):
            got = None
            for c in list(free):
                if used_until[c] < b:
                    got = c
                    free.remove(c)
                    break
            if got is None:
                got = depth
                depth += 1
            cells[u] = got
            used_until[got] = d
            free.append(got)
        return cells, depth

    tabs = {name: np.full((P, T), -1, np.int32)
            for name in ("f_m", "f_j", "f_cell", "a_cell",
                         "b_m", "b_j", "b_cell", "d_arr", "d_use")}
    K = D = 1
    for s in range(P):
        ivals, divals = {}, {}
        for j in range(V):
            g = j * P + s
            for m in range(M):
                birth = fs[(g, m)] if g == 0 else fs[(g - 1, m)] + 1
                ivals[(j, m)] = (birth, bs[(g, m)])
                if g < VP - 1:
                    divals[(j, m)] = (bs[(g + 1, m)] + 1, bs[(g, m)])
        cells, k = color(ivals)
        dcells, d = color(divals)
        K, D = max(K, k), max(D, d)
        for j in range(V):
            g = j * P + s
            for m in range(M):
                tf, tb = fs[(g, m)], bs[(g, m)]
                assert tabs["f_m"][s, tf] == -1 and \
                    tabs["b_m"][s, tf] == -1, (s, tf)
                assert tabs["f_m"][s, tb] == -1 and \
                    tabs["b_m"][s, tb] == -1, (s, tb)
                tabs["f_m"][s, tf] = m
                tabs["f_j"][s, tf] = j
                tabs["f_cell"][s, tf] = cells[(j, m)]
                tabs["b_m"][s, tb] = m
                tabs["b_j"][s, tb] = j
                tabs["b_cell"][s, tb] = cells[(j, m)]
                if g > 0:
                    tabs["a_cell"][s, fs[(g - 1, m)] + 1] = cells[(j, m)]
                if g < VP - 1:
                    tabs["d_arr"][s, bs[(g + 1, m)] + 1] = dcells[(j, m)]
                    tabs["d_use"][s, tb] = dcells[(j, m)]

    sched = _Sched1F1B(P, V, T, K, D, **tabs)
    _replay_check(sched, M)
    return sched


def _replay_check(sc: _Sched1F1B, M: int):
    """Symbolic replay of the tables against the slot semantics of the
    engine (bank arrivals, forward, backward, ring hops): every forward
    consumes the right microbatch and chunk input, every backward reads
    the same cell again and seeds from the right cotangent, and no live
    buffer cell is overwritten."""
    P, V, T = sc.P, sc.V, sc.T
    VP = V * P
    ib = [dict() for _ in range(P)]       # device -> cell -> tag
    db = [dict() for _ in range(P)]
    fmsg = [None] * P                     # in flight toward device s
    bmsg = [None] * P
    done_f, done_b = set(), set()
    for t in range(T):
        sent_f, sent_b = [None] * P, [None] * P
        for s in range(P):
            ac = sc.a_cell[s, t]
            if ac >= 0:
                assert fmsg[s] is not None, (s, t)
                ib[s][ac] = fmsg[s]
            dc = sc.d_arr[s, t]
            if dc >= 0:
                assert bmsg[s] is not None, (s, t)
                db[s][dc] = bmsg[s]
            mf = sc.f_m[s, t]
            if mf >= 0:
                j = sc.f_j[s, t]
                g = j * P + s
                if g == 0:
                    ib[s][sc.f_cell[s, t]] = ("act", 0, mf)
                tag = ib[s].get(sc.f_cell[s, t])
                assert tag == ("act", g, mf), (s, t, tag, g, mf)
                sent_f[s] = ("act", g + 1, mf)   # consumed by stage g+1
                done_f.add((g, mf))
            mb = sc.b_m[s, t]
            if mb >= 0:
                j = sc.b_j[s, t]
                g = j * P + s
                tag = ib[s].get(sc.b_cell[s, t])
                assert tag == ("act", g, mb), (s, t, tag, g, mb)
                if g == VP - 1:
                    assert (g, mb) in done_f, (s, t)
                else:
                    dtag = db[s].get(sc.d_use[s, t])
                    assert dtag == ("cot", g, mb), (s, t, dtag, g, mb)
                done_b.add((g, mb))
                sent_b[s] = ("cot", g - 1, mb)
        # Ring hops: forward s -> s+1 (the wrap advances the chunk),
        # backward the reverse; the tags already carry g+1 / g-1.
        fmsg = [sent_f[(s - 1) % P] for s in range(P)]
        bmsg = [sent_b[(s + 1) % P] for s in range(P)]
    assert done_f == {(g, m) for g in range(VP) for m in range(M)}
    assert done_b == done_f


def _schedule_1f1b(P: int, M: int):
    """The non-interleaved 1F1B timetable in closed form: the executable
    spec that :func:`_sched_1f1b_tables` reproduces at V = 1.

    Each slot holds at most one op per stage (a forward or a backward of
    one microbatch). Stage s runs its warm-up forwards at slots ``s + m``
    (m < P - s), steady-state forwards at ``2m + s`` and backwards at
    ``2P - 1 - s + 2m``: after warm-up each backward's freed activation is
    refilled by one forward, so at most ``P - s`` microbatches are in
    flight at stage s (O(pp), independent of n_micro).

    Returns ``(T, fwd, bwd, arr, K)``: total slots; [P, T] int arrays
    with the microbatch forwarded or backwarded by stage s at slot t (-1
    idle); arrivals ``arr[s][t]``, the microbatch whose activation reaches
    stage s at slot t (sent by s - 1 a slot earlier); and K, the input
    buffer depth, the most microbatch activations alive (arrival to
    backward) at any stage. Every constraint is asserted here."""
    f_slot = {}
    b_slot = {}
    for s in range(P):
        for m in range(M):
            f_slot[(s, m)] = s + m if m <= P - 1 - s else 2 * m + s
            b_slot[(s, m)] = 2 * P - 1 - s + 2 * m
    T = max(b_slot.values()) + 1

    fwd = np.full((P, T), -1, np.int32)
    bwd = np.full((P, T), -1, np.int32)
    arr = np.full((P, T), -1, np.int32)
    for (s, m), t in f_slot.items():
        assert fwd[s, t] == -1 and bwd[s, t] == -1, (s, t)
        fwd[s, t] = m
    for (s, m), t in b_slot.items():
        assert fwd[s, t] == -1 and bwd[s, t] == -1, (s, t)
        bwd[s, t] = m
    for s in range(1, P):
        for m in range(M):
            t_arr = f_slot[(s - 1, m)] + 1
            assert t_arr <= f_slot[(s, m)], (s, m)   # arrives before use
            arr[s, t_arr] = m
    for s in range(P - 1):
        for m in range(M):
            # dx from stage s+1 lands exactly on stage s's backward slot.
            assert b_slot[(s + 1, m)] + 1 == b_slot[(s, m)], (s, m)
    for m in range(M):
        assert b_slot[(P - 1, m)] == f_slot[(P - 1, m)] + 1, m

    K = 0
    for s in range(P):
        births = {m: (f_slot[(s - 1, m)] + 1 if s else f_slot[(s, m)])
                  for m in range(M)}
        for t in range(T):
            live = sum(1 for m in range(M)
                       if births[m] <= t <= b_slot[(s, m)])
            K = max(K, live)
    return T, fwd, bwd, arr, K


def _pipeline_1f1b_engine(stage_fn: Callable, chunk_params, xs,
                          axis_name: str, n_virtual: int, *,
                          loss_side: Callable, zero_head,
                          embed_side: Callable | None = None,
                          aux_seed=None, aux_gate=None,
                          lockstep: bool = False):
    """The 1F1B slot engine: the one place the timetable and the ring
    buffers live.

    * ``chunk_params``: this device's chunks, a (nested) dict of tensors
      with a leading axis of ``n_virtual`` (lift v = 1 params with
      ``[None]``).
    * ``xs`` [n_micro, micro_batch, ...]: the global stage 0 inputs.
    * ``loss_side(y, m) -> (lval, head_grads, dy)``: called at the global
      last stage's backward with that chunk's (detached) output: the
      microbatch's loss value, gradients for the head or tail parameters
      it closes over (``zero_head``'s structure; ``{}`` if none), and the
      cotangent that seeds the backward. Collective-free.
    * ``embed_side(dx, m) -> head_grads``: optional, called at the global
      first stage's backward with the input cotangent: the embedding's
      gradient path. Collective-free.
    * ``aux_seed`` / ``aux_gate``: when ``stage_fn`` returns ``(y, aux)``,
      the cotangent of each aux scalar in every backward, and whether
      this rank accumulates the aux values (the exclusive-path rule of
      the train step).
    * ``lockstep``: in the JAX package, ``False`` runs each slot's ops
      under a per-device cond (``stage_fn`` collective-free) and ``True``
      computes both bodies on every rank and masks the results, because
      every device of an SPMD program executes every collective. Here a
      collective runs on the process group of one axis line, and only that
      line's members take part. The ranks that share a stage's collectives
      (its tp and dp peers) share its timetable, so each slot runs only its
      scheduled op in both modes: the same results, and half the work of
      the masked bodies.

    Returns ``(lacc, aux_acc, chunk_grads, head_grads)``: raw
    accumulators, the caller normalizes and reduces them.

    Memory: autograd never crosses the slot loop. A forward runs under
    ``no_grad`` and banks its input; its backward re-runs the chunk from
    that input with autograd on and back-propagates the banked cotangent
    (``torch.autograd.backward``), reading the input's ``.grad`` as the dx
    it sends on. So the activations alive are the K-deep input buffer,
    O(n_virtual * pp), flat in n_micro."""
    del lockstep  # only scheduled ops run (see above)
    P = axis_size(axis_name)
    stage = axis_index(axis_name)
    V = n_virtual
    M = xs.shape[0]
    sc = _sched_1f1b_tables(P, M, V)
    has_aux = aux_seed is not None
    last = P - 1
    # Ring permutes in both directions. The wrap hop only advances the
    # chunk, so at V = 1 it carries nothing and is left out.
    if V > 1:
        fwd_perm = [(i, (i + 1) % P) for i in range(P)]
        bwd_perm = [(i, (i - 1) % P) for i in range(P)]
    else:
        fwd_perm = [(i, i + 1) for i in range(P - 1)]
        bwd_perm = [(i, i - 1) for i in range(1, P)]

    zero_act = torch.zeros_like(xs[0])
    # Leaves whose .grad accumulates every backward's chunk gradients.
    live = _tree(lambda p: p.detach().requires_grad_(), chunk_params)
    gh = _tree(torch.zeros_like, zero_head)
    lacc = torch.zeros((), dtype=torch.float32, device=xs.device)
    aux_acc = None
    ib, dxb = [None] * sc.K, [None] * sc.D
    fmsg = bmsg = zero_act

    def add_head(d):
        for a, b in zip(_leaves(gh), _leaves(d)):
            a.add_(b)

    for t in range(sc.T):
        # 1) Bank arrivals (messages the neighbours sent last slot).
        if sc.a_cell[stage, t] >= 0:
            ib[sc.a_cell[stage, t]] = fmsg
        if sc.d_arr[stage, t] >= 0:
            dxb[sc.d_arr[stage, t]] = bmsg

        # 2) Forward: bank the input (global stage 0 banks its fresh
        # microbatch) and send the output on.
        y_f = zero_act
        mf = int(sc.f_m[stage, t])
        if mf >= 0:
            jf, cf = int(sc.f_j[stage, t]), int(sc.f_cell[stage, t])
            x = xs[mf] if stage == 0 and jf == 0 else ib[cf]
            ib[cf] = x
            with torch.no_grad():
                out = stage_fn(_tree(lambda q: q[jf], live), x)
            y_f = out[0] if has_aux else out

        # 3) Backward: re-run the chunk from the banked input, seed from
        # the loss (global last stage) or the banked dx.
        dx_out = zero_act
        mb = int(sc.b_m[stage, t])
        if mb >= 0:
            jb, cb = int(sc.b_j[stage, t]), int(sc.b_cell[stage, t])
            with torch.enable_grad():
                x = ib[cb].detach().requires_grad_()
                # Every rank of the stage back-propagates through every
                # collective of the re-run (collective.tape).
                with tape(xs.device) as tp:
                    out = stage_fn(_tree(lambda q: q[jb], live), x)
                y_b = tp.sink(out[0] if has_aux else out)
                if stage == last and jb == V - 1:
                    lval, d_head, dy = loss_side(y_b.detach(), mb)
                    lacc = lacc + lval
                    add_head(d_head)
                else:
                    dy = dxb[int(sc.d_use[stage, t])].to(y_b.dtype)
                outs, seeds = [y_b], [dy]
                if has_aux:
                    outs += list(out[1])
                    seeds += [torch.as_tensor(s, dtype=a.dtype,
                                              device=a.device)
                              for s, a in zip(aux_seed, out[1])]
                pairs = [(o, g) for o, g in zip(outs, seeds)
                         if o.requires_grad]
                torch.autograd.backward([o for o, _ in pairs],
                                        [g for _, g in pairs])
            dx_out = x.grad if x.grad is not None else zero_act
            if embed_side is not None and stage == 0 and jb == 0:
                add_head(embed_side(dx_out, mb))
            if has_aux and aux_gate:
                vals = tuple(a.detach() for a in out[1])
                aux_acc = vals if aux_acc is None else tuple(
                    a + b for a, b in zip(aux_acc, vals))

        # 4) Exchanges: activations ride the ring rightward, cotangents
        # leftward.
        fmsg = ppermute(y_f, axis_name, fwd_perm)
        bmsg = ppermute(dx_out, axis_name, bwd_perm)

    if has_aux and aux_acc is None:     # a rank that accumulates no aux
        aux_acc = tuple(torch.zeros((), dtype=torch.float32,
                                    device=xs.device) for _ in aux_seed)
    gl = _tree(lambda p: p.grad if p.grad is not None
               else torch.zeros_like(p), live)
    return lacc, aux_acc, gl, gh


def pipeline_1f1b_loss_and_grads(stage_fn: Callable,
                                 per_micro_loss: Callable, stage_params,
                                 xs, targets, axis_name: str,
                                 n_virtual: int = 1):
    """Pipeline loss and gradients under the 1F1B schedule.

    ``stage_params`` as for :func:`pipeline_forward` (leading stage axis
    1; with ``n_virtual > 1``, [1, n_virtual, ...] as for
    :func:`pipeline_forward_interleaved`, and ``n_micro % pp == 0``);
    ``xs`` and ``targets`` [n_micro, micro_batch, ...].

    Returns ``(loss, stage_grads)``: the mean of
    ``per_micro_loss(y_m, targets[m])`` over microbatches, and this
    stage's parameter gradients in ``stage_params``' structure, equal to
    autograd through :func:`pipeline_loss` up to summation order.
    ``stage_fn`` must be collective-free; embedding and head parameters
    outside ``stage_params`` are the caller's."""
    n_micro = xs.shape[0]
    params = _first(stage_params)
    if n_virtual == 1:
        params = _tree(lambda p: p[None], params)        # chunk axis

    def loss_side(y, m):
        tgt = targets[m]
        with torch.enable_grad():
            yy = y.detach().requires_grad_()
            lval = per_micro_loss(yy, tgt)
            (dy,) = torch.autograd.grad(lval, yy)
        return lval.detach().float(), {}, dy.to(y.dtype)

    lacc, _, gl, _ = _pipeline_1f1b_engine(
        stage_fn, params, xs, axis_name, n_virtual,
        loss_side=loss_side, zero_head={})
    loss = psum(lacc, axis_name) / n_micro
    if n_virtual == 1:
        gl = _tree(lambda g: g[0], gl)                   # drop chunk axis
    return loss, _tree(lambda g: (g / n_micro)[None], gl)


def run_pipeline(mesh, stage_fn: Callable, stacked_params, xs,
                 axis_name: str = "pp"):
    """Tensor-level convenience: :func:`pipeline_forward` over ``mesh``,
    ``stacked_params``' leading axis the stage."""
    with mesh:
        return pipeline_forward(stage_fn, stacked_params, xs, axis_name)
