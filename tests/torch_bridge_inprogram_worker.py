"""One acxrun rank of the in-program partitioned publish (the torch twin of
tests/device_bridge_inprogram_worker.py).

Run: ``build/acxrun -np 2 python tests/torch_bridge_inprogram_worker.py
[--device cuda|cpu] [--parts P] [--part-shape R C] [--stagger-s S]``.

Rank 0 issues the whole round as one stream program, as
tests/torch_bridge_worker.py does in its ``produce_and_pready`` mode: per
partition the B5 kernel, the copies to the wire buffer, and a trigger that
publishes the flag words when the stream reaches it. The host does not wait
for the card between partitions; it sleeps ``--stagger-s`` before each
partition after the first, to stand for producing it.

Overlap is proved by order, not by timing: the sender holds its last
partition until the receiver reports, by a message on a second tag, that it
saw a partly filled flag table. The receiver can only see that while the
sender's round is still in flight, and the sender cannot finish without it.

Rank 1 polls the native table into a device mirror, lets the B3 kernel
decide each partition's arrival and the B4 kernel the round's, and checks
every value on its device.

Prints ``INPROGRAM_OK <parts> <partial>`` on each rank, ``<partial>`` being
the count of arrived partitions the receiver reported.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from mpi_acx_torch import triggers  # noqa: E402
from mpi_acx_torch.device import resolve_device  # noqa: E402
from mpi_acx_torch.runtime import Runtime  # noqa: E402
from torch_bridge_worker import Receiver, Sender  # noqa: E402

REPORT_TAG = 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--part-shape", type=int, nargs=2, default=(8, 128))
    ap.add_argument("--stagger-s", type=float, default=0.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.set_num_threads(1)    # two ranks share the cores with the proxies
    P = args.parts
    if P < 2:
        raise SystemExit("the overlap proof needs at least 2 partitions")
    rt = Runtime()
    if rt.size != 2:
        raise SystemExit(f"needs 2 ranks, got {rt.size}")
    peer = 1 - rt.rank
    shape = tuple(args.part_shape)

    if rt.rank == 0:
        side = Sender(rt, dev, P, shape, peer)
        report = []

        def hold(p):
            if p:
                time.sleep(args.stagger_s)
            if p == P - 1:
                # The receiver's report: how many partitions it saw arrived.
                got = triggers.recv_in_program(rt, (1,), torch.int32, peer,
                                               REPORT_TAG, device="cpu")
                report.append(int(got[0]))

        side.round("produce_and_pready", 0, hold=hold)
        if side.published != P:
            raise RuntimeError(f"published {side.published} of {P}")
        partial = report[0]
    else:
        side = Receiver(rt, dev, P, shape, peer)

        def on_partial(count):
            triggers.send_in_program(
                rt, torch.tensor([count], dtype=torch.int32), peer,
                REPORT_TAG)

        side.round(0, on_partial=on_partial)
        if triggers.drain_sends(rt) != 1:
            raise RuntimeError("the partial-table report was not sent")
        side.check("in-program round")
        partial = side.max_partial
    if not 0 < partial < P:
        raise RuntimeError(f"no partly filled table was seen ({partial})")
    rt.request_free(side.req)
    rt.barrier()
    print(f"INPROGRAM_OK {P} {partial}", flush=True)
    rt.finalize()


if __name__ == "__main__":
    main()
