"""One acxrun rank of the port's stream-ordered triggers (the torch twin of
tests/xla_triggers_worker.py), and of the triggered ping-pong.

Run: ``build/acxrun -np 2 python tests/torch_triggers_worker.py [--device
cuda|cpu] [--pingpong ITERS] [--msg-bytes B]``.

Each rank computes on its device, places a send trigger of the
intermediate on the stream (mpi_acx_torch.triggers.send_in_program),
receives the peer's intermediate (recv_in_program) and consumes it in
further computation; run twice, the triggers fire again. Prints
``TRIG_OK <value>``.

With ``--pingpong ITERS``: rank 0 sends a ``--msg-bytes`` tensor (f32, on
the device) through a trigger and waits for rank 1 to echo it through its
own trigger, ITERS times after 200 warm-up exchanges (as
build/bench_pingpong does); the one-way latency is half the round trip,
which ends with the echo on rank 0's device. ``--echo-device`` puts rank
1's tensors elsewhere (default: ``--device``), so that only one process
uses the card. Rank 0 prints ``PINGPONG p50_us=<v> p99_us=<v> iters=<n>
msg_bytes=<b>``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_acx_torch import triggers  # noqa: E402
from mpi_acx_torch.device import resolve_device  # noqa: E402
from mpi_acx_torch.runtime import Runtime  # noqa: E402

N = 64
WARMUP = 200


def exchange(rt, dev, x):
    """Compute, trigger the send mid-stream, receive the peer's value and
    consume it."""
    peer = 1 - rt.rank
    y = x * 2.0 + rt.rank
    triggers.send_in_program(rt, y, peer, tag=7)
    z = triggers.recv_in_program(rt, (N,), torch.float32, peer, tag=7,
                                 device=dev)
    return (y + z).sum(), z


def pingpong(rt, dev, iters, msg_bytes):
    peer = 1 - rt.rank
    msg = torch.arange(msg_bytes // 4, dtype=torch.float32, device=dev) + 1
    lat, split = [], []
    back = None
    for it in range(-WARMUP, iters):
        t0 = time.perf_counter()
        if rt.rank == 0:
            triggers.send_in_program(rt, msg, peer, tag=3)
            t1 = time.perf_counter()
            back = triggers.recv_in_program(rt, msg.shape, msg.dtype, peer,
                                            tag=3, device=dev)
            t2 = time.perf_counter()
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            t3 = time.perf_counter()
            triggers.drain_sends(rt)
            t4 = time.perf_counter()
            if it >= 0:
                lat.append((t4 - t0) / 2 * 1e6)
                split.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
        else:
            back = triggers.recv_in_program(rt, msg.shape, msg.dtype, peer,
                                            tag=3, device=dev)
            triggers.send_in_program(rt, back, peer, tag=3)
            triggers.drain_sends(rt)
    if not torch.equal(back, msg):
        raise RuntimeError("the echoed message differs")
    if rt.rank == 0:
        lat.sort()
        print(f"PINGPONG p50_us={lat[len(lat) // 2]:.3f} "
              f"p99_us={lat[int(len(lat) * 0.99)]:.3f} iters={iters} "
              f"msg_bytes={msg_bytes}", flush=True)
        # Median of each leg of rank 0's round trip: placing the send
        # trigger, the receive (until the reply is on the host), the copy
        # to the device, and draining the send.
        med = np.median(np.asarray(split), axis=0) * 1e6
        print("PINGPONG_SPLIT " + " ".join(
            f"{k}_us={v:.3f}" for k, v in zip(
                ("trigger", "recv", "to_device", "drain"), med)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pingpong", type=int, default=0, metavar="ITERS")
    ap.add_argument("--msg-bytes", type=int, default=8)
    ap.add_argument("--echo-device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.set_num_threads(1)    # two ranks share the cores with the proxies
    rt = Runtime()
    if rt.size != 2:
        raise SystemExit(f"needs 2 ranks, got {rt.size}")
    rank, peer = rt.rank, 1 - rt.rank
    x = torch.arange(N, dtype=torch.float32, device=dev)
    ys = [2.0 * np.arange(N) + r for r in (0, 1)]
    expect = float((ys[rank] + ys[peer]).sum())
    for _ in range(2):      # the second run fires the triggers again
        total, z = exchange(rt, dev, x)
        if triggers.drain_sends(rt) != 1:
            raise RuntimeError("one send per run")
        np.testing.assert_array_equal(z.cpu().numpy(), ys[peer])
        if float(total) != expect:
            raise RuntimeError(f"total {float(total)} != {expect}")
    if args.pingpong:
        if args.msg_bytes <= 0 or args.msg_bytes % 4:
            raise SystemExit("--msg-bytes: a positive multiple of 4")
        echo = args.echo_device or args.device
        pingpong(rt, dev if rank == 0 else resolve_device(echo),
                 args.pingpong, args.msg_bytes)
    rt.barrier()
    print(f"TRIG_OK {expect}", flush=True)
    rt.finalize()


if __name__ == "__main__":
    main()
