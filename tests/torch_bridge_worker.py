"""One acxrun rank of the port's device-triggered partitioned exchange (the
torch twin of tests/device_bridge_worker.py).

Run: ``build/acxrun -np 2 python tests/torch_bridge_worker.py [--device
cuda|cpu] [--parts P] [--part-shape R C] [--modes M ...] [--sets S]
[--rounds N]``. The defaults are the JAX worker's: 4 partitions of 8x128
f32, payload ``(p + 1) * 2 + 1``, one round, so either rank may be the JAX
worker instead (the flag words and the wire are the shared contract).

Rank 0 (sender), per round and partition ``p``, by mode:

* ``produce_and_pready`` (B5): one kernel computes the payload
  ``Affine(2, 1)(x_p)`` and marks flag ``p`` PENDING;
* ``pready`` (B1): a plain producer, then the B1 kernel marks ``p``;
* ``pready_many`` (B2): the plain producer makes every partition, then one
  B2 kernel marks them all (the ``mark_ready<<<1,N>>>`` launch).

A non-blocking copy lands the payload in the pinned wire buffer, a second
one copies the flag words after it, and a trigger placed on the stream
behind both (mpi_acx_torch.triggers) publishes the flag words into the
native table, so the proxy sends partition ``p`` while the card produces
the next ones. The payload is in the wire buffer before its flag is
published, and the host never synchronises the device.

Rank 1 (receiver) polls the native table into a device mirror, consumes
each partition as the B3 kernel reports it (a copy to the card and a check
of every value there), and ends the round on the B4 kernel.

``x_p`` is ``p + 1 + r * P`` in round ``r`` (counted over all modes), so a
partition published before its payload shows as a stale value. Each rank
prints ``BRIDGE_OK <parts>``; rank 0 prints one ``BRIDGE_BW`` line per mode
(the best of its sets' GB/s, a set being ``--rounds`` rounds closed by a
barrier, as build/bench_pingpong times them), and each rank its kernel
launches as ``LAUNCHES <json>``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from mpi_acx_torch import triggers  # noqa: E402
from mpi_acx_torch.device import resolve_device  # noqa: E402
from mpi_acx_torch.ops import flags as fl  # noqa: E402
from mpi_acx_torch.runtime import Runtime  # noqa: E402

MODES = ("produce_and_pready", "pready", "pready_many")
PRODUCE = fl.Affine(2.0, 1.0)       # the JAX workers' lambda t: t * 2 + 1
POLL_TIMEOUT_S = 120.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--part-shape", type=int, nargs=2, default=(8, 128))
    ap.add_argument("--modes", nargs="+", choices=MODES,
                    default=["produce_and_pready"])
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=1)
    return ap.parse_args(argv)


def reset_launches():
    for fn in (fl.pready, fl.pready_many, fl.parrived, fl.parrived_all,
               fl.produce_and_pready):
        fn.launches = 0


def launches():
    return {"pready": fl.pready.launches,
            "pready_many": fl.pready_many.launches,
            "parrived": fl.parrived.launches,
            "parrived_all": fl.parrived_all.launches,
            "produce_and_pready": fl.produce_and_pready.launches}


def payload_value(p, rnd, parts):
    """Every value of partition ``p`` in round ``rnd``: Affine(2, 1) of
    ``p + 1 + rnd * parts``, exact in f32 for the sizes used."""
    return (p + 1 + rnd * parts) * 2.0 + 1.0


class Sender:
    def __init__(self, rt, dev, parts, shape, peer):
        self.rt, self.dev, self.parts, self.shape = rt, dev, parts, shape
        pinned = dev.type == "cuda"
        self.wire = torch.zeros((parts, *shape), dtype=torch.float32,
                                pin_memory=pinned)
        self.req = rt.psend_init(self.wire, parts, dest=peer)
        # One row of flag words per partition, so each trigger reads the
        # snapshot copied behind its own payload.
        self.snap = torch.zeros((parts, parts), dtype=torch.int32,
                                pin_memory=pinned)
        self.flags = torch.empty(parts, dtype=torch.int32, device=dev)
        self.idxs = torch.arange(parts, dtype=torch.int32, device=dev)
        self.published = 0

    def _publish(self, p, row):
        """Place the trigger that mirrors snapshot ``row`` into the native
        table once the stream has copied it (behind the payload)."""
        snap = self.snap[row]

        def fire():
            if p is not None and int(snap[p]) != fl.PENDING:
                raise RuntimeError(f"partition {p}: flag word {int(snap[p])} "
                                   "after its producer, not PENDING")
            self.published += self.rt.publish_partition_flags(self.req, snap)
        self.snap[row].copy_(self.flags, non_blocking=True)
        triggers.when_reached(self.rt, fire, self.dev)
        self.last_row = row

    def round(self, mode, rnd, hold=None):
        """One round; ``hold(p)``, if given, runs on the host before
        partition ``p`` is produced."""
        P = self.parts
        self.rt.start(self.req)
        self.flags.fill_(fl.RESERVED)
        xs = [torch.full(self.shape, float(p + 1 + rnd * P),
                         device=self.dev) for p in range(P)]
        if mode == "pready_many":
            for p in range(P):
                if hold:
                    hold(p)
                self.wire[p].copy_(PRODUCE(xs[p]), non_blocking=True)
            fl.pready_many(self.flags, self.idxs)
            self._publish(None, 0)
        else:
            for p in range(P):
                if hold:
                    hold(p)
                if mode == "produce_and_pready":
                    payload, _ = fl.produce_and_pready(PRODUCE, xs[p],
                                                       self.flags, p)
                else:
                    payload = PRODUCE(xs[p])
                    fl.pready(self.flags, p)
                self.wire[p].copy_(payload, non_blocking=True)
                self._publish(p, p)
        triggers.flush(self.rt)
        # Re-publishing a table is idempotent (a CAS natively): the slots
        # are PENDING or past it until the wait below returns.
        if self.rt.publish_partition_flags(self.req,
                                           self.snap[self.last_row]) != 0:
            raise RuntimeError("re-publishing a flag table published again")
        self.rt.wait(self.req)


class Receiver:
    def __init__(self, rt, dev, parts, shape, peer):
        self.rt, self.dev, self.parts, self.shape = rt, dev, parts, shape
        pinned = dev.type == "cuda"
        self.wire = torch.zeros((parts, *shape), dtype=torch.float32,
                                pin_memory=pinned)
        self.req = rt.precv_init(self.wire, parts, source=peer)
        self.mirror = torch.zeros(parts, dtype=torch.int32, device=dev)
        self.idxs = torch.arange(parts, dtype=torch.int32, device=dev)
        self.recv = torch.empty((parts, *shape), dtype=torch.float32,
                                device=dev)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.max_partial = 0       # most partitions seen arrived, short of all

    def poll(self, pending):
        """Native words -> device mirror -> B3 per pending partition;
        returns their 0/1 arrivals, as decided by the kernel."""
        self.mirror.copy_(self.rt.fetch_partition_flags(self.req))
        return torch.stack([fl.parrived(self.mirror, p)
                            for p in pending]).tolist()

    def round(self, rnd, on_partial=None):
        """One round; ``on_partial(count)`` runs the first time a poll sees
        some but not all partitions arrived."""
        P = self.parts
        self.rt.start(self.req)
        pending = set(range(P))
        deadline = time.monotonic() + POLL_TIMEOUT_S
        while pending:
            order = sorted(pending)
            new = [p for p, hit in zip(order, self.poll(order)) if hit]
            for p in new:
                # Consume: to the card, and check every value there.
                self.recv[p].copy_(self.wire[p], non_blocking=True)
                self.bad += (self.recv[p] != payload_value(p, rnd, P)).sum()
                pending.discard(p)
            count = P - len(pending)
            if 0 < count < P:
                if on_partial is not None and self.max_partial == 0:
                    on_partial(count)
                self.max_partial = max(self.max_partial, count)
            if not new:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"partitions {sorted(pending)} never "
                                       "arrived")
                time.sleep(20e-6)
        if int(fl.parrived_all(self.mirror, self.idxs)) != 1:
            raise RuntimeError("every partition arrived by B3 but B4 says no")
        # The wire buffer is refilled by the next round's start: the copies
        # out of it must be done first.
        ev = torch.cuda.Event() if self.dev.type == "cuda" else None
        if ev is not None:
            ev.record()
            ev.synchronize()
        self.rt.wait(self.req)

    def check(self, what):
        bad = int(self.bad)
        if bad:
            raise RuntimeError(f"{what}: {bad} received values differ from "
                               "the sender's payload")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.set_num_threads(1)    # two ranks share the cores with the proxies
    rt = Runtime()
    if rt.size != 2:
        raise SystemExit(f"torch_bridge_worker needs 2 ranks, got {rt.size}")
    peer = 1 - rt.rank
    shape = tuple(args.part_shape)
    nbytes = args.parts * shape[0] * shape[1] * 4
    side = (Sender if rt.rank == 0 else Receiver)(rt, dev, args.parts,
                                                  shape, peer)
    reset_launches()
    rnd = 0
    for mode in args.modes:
        best = 0.0
        # A set is its rounds and one barrier; the first set starts when
        # both ranks are up, each later one at the previous barrier. With
        # one set of one round this is the JAX worker's protocol: one
        # exchange, one barrier.
        for _ in range(args.sets):
            t0 = time.perf_counter()
            for _ in range(args.rounds):
                if rt.rank == 0:
                    side.round(mode, rnd)
                else:
                    side.round(rnd)
                rnd += 1
            rt.barrier()
            best = max(best, nbytes * args.rounds
                       / (time.perf_counter() - t0) / 1e9)
        if rt.rank == 1:
            side.check(mode)
        else:
            print(f"BRIDGE_BW mode={mode} gbps={best:.3f} bytes={nbytes} "
                  f"parts={args.parts} sets={args.sets} rounds={args.rounds}",
                  flush=True)
    if rt.rank == 0 and side.published != args.parts * rnd:
        raise RuntimeError(f"published {side.published} partitions, "
                           f"expected {args.parts * rnd}")
    print(f"LAUNCHES {json.dumps(launches())}", flush=True)
    rt.request_free(side.req)
    print(f"BRIDGE_OK {args.parts}", flush=True)
    rt.finalize()


if __name__ == "__main__":
    main()
