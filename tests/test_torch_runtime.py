"""The port's ctypes binding (mpi_acx_torch.runtime) and stream triggers
(mpi_acx_torch.triggers) on CPU tensors: the loopback runtime in this
process (as tests/test_runtime.py drives the JAX package's binding), the
flag bridge, bfloat16 as uint8 bytes, and a 2-rank ring under
build/acxrun running this file as the worker."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    subprocess.run(["make", "-C", REPO, "lib", "tools"], check=True,
                   capture_output=True, timeout=600)
    from mpi_acx_torch import runtime
    r = runtime.Runtime()
    yield r
    r.finalize()


def test_loopback_enqueued_sendrecv(rt):
    assert rt.rank == 0 and rt.size == 1
    src = torch.arange(64, dtype=torch.float32)
    dst = torch.zeros(64, dtype=torch.float32)
    s = rt.isend_enqueue(src, dest=0, tag=5)
    r = rt.irecv_enqueue(dst, source=0, tag=5)
    st = rt.wait(r)
    rt.wait(s)
    assert torch.equal(src, dst)            # received into dst's own memory
    assert st.MPI_SOURCE == 0 and st.MPI_TAG == 5
    assert st.acx_bytes == 64 * 4


def test_bf16_travels_as_bytes(rt):
    src = torch.randn(3, 40, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    dst = torch.zeros_like(src)
    s = rt.isend_enqueue(src, dest=0, tag=6)
    st = rt.wait(rt.irecv_enqueue(dst, source=0, tag=6))
    rt.wait(s)
    assert st.acx_bytes == src.numel() * 2
    assert torch.equal(src.view(torch.int16), dst.view(torch.int16))


def test_loopback_partitioned_rounds(rt):
    parts = 8
    send = torch.arange(32, dtype=torch.int32)
    recv = torch.zeros(32, dtype=torch.int32)
    sreq = rt.psend_init(send, parts, dest=0, tag=9)
    rreq = rt.precv_init(recv, parts, source=0, tag=9)
    for rnd in range(3):
        send[:] = torch.arange(32) * (rnd + 1)
        recv[:] = -1
        rt.start(sreq)
        rt.start(rreq)
        for p in reversed(range(parts)):  # out-of-order readiness
            rt.pready(p, sreq)
        while not rt.parrived(rreq, parts - 1):
            pass
        rt.wait(sreq)
        rt.wait(rreq)
        assert torch.equal(recv, torch.arange(32, dtype=torch.int32)
                           * (rnd + 1))
    rt.request_free(sreq)
    rt.request_free(rreq)


def test_flag_bridge_publish_and_fetch(rt):
    """A device-style flag table published into the native table drives
    the transfer; the receiver's native words come back COMPLETED."""
    from mpi_acx_torch.ops import flags as fl
    parts = 4
    send = torch.arange(16, dtype=torch.float32)
    recv = torch.zeros(16, dtype=torch.float32)
    sreq = rt.psend_init(send, parts, dest=0, tag=11)
    rreq = rt.precv_init(recv, parts, source=0, tag=11)
    assert len(rt.partition_slots(sreq)) == parts
    rt.start(sreq)
    rt.start(rreq)
    table = torch.full((parts,), fl.RESERVED, dtype=torch.int32)
    fl.pready(table, 2)
    assert rt.publish_partition_flags(sreq, table) == 1
    assert rt.publish_partition_flags(sreq, table) == 0      # idempotent
    fl.pready_many(table, [0, 1, 3])
    assert rt.publish_partition_flags(sreq, table) == 3
    for _ in range(100000):
        mirror = rt.fetch_partition_flags(rreq)
        if int(fl.parrived_all(mirror, list(range(parts)))):
            break
    assert mirror.tolist() == [fl.COMPLETED] * parts
    rt.wait(sreq)
    rt.wait(rreq)
    assert torch.equal(send, recv)
    with pytest.raises(ValueError, match="flag table"):
        rt.publish_partition_flags(sreq, torch.zeros(2, dtype=torch.int32))
    rt.request_free(sreq)
    rt.request_free(rreq)


def test_wire_buffers_are_checked(rt):
    with pytest.raises(ValueError, match="contiguous"):
        rt.isend_enqueue(torch.zeros(4, 4).t(), dest=0)
    with pytest.raises(TypeError, match="dtype"):
        rt.isend_enqueue(torch.zeros(4, dtype=torch.float16), dest=0)
    with pytest.raises(TypeError, match="CPU tensor"):
        rt.irecv_enqueue(torch.zeros(4, device="meta"), source=0)
    with pytest.raises(ValueError, match="partitions"):
        rt.psend_init(torch.zeros(10), 3, dest=0)


def test_triggers_fire_at_once_on_cpu(rt):
    from mpi_acx_torch import triggers
    x = torch.arange(8, dtype=torch.float32)
    assert triggers.send_in_program(rt, x, 0, tag=13) is x
    x += 100                  # the trigger sent the value x had when placed
    z = triggers.recv_in_program(rt, (8,), torch.float32, 0, tag=13,
                                 device="cpu")
    assert torch.equal(z, torch.arange(8, dtype=torch.float32))
    assert triggers.drain_sends(rt) == 1
    assert triggers.drain_sends(rt) == 0
    fired = []
    triggers.when_reached(rt, lambda: fired.append(1), "cpu")
    assert fired == [1]


def test_trigger_thread_runs_in_order_and_reports_errors():
    """The per-stream trigger thread runs actions in placement order and
    raises an action's error at the next flush (no card needed: the
    thread is fed without events)."""
    from mpi_acx_torch.triggers import _Trigger
    trig = _Trigger("test")
    seen = []
    for i in range(50):
        trig.put(None, lambda i=i: seen.append(i))
    trig.flush()
    assert seen == list(range(50))

    def boom():
        raise OSError("action failed")
    trig.put(None, boom)
    trig.put(None, lambda: seen.append("after"))
    with pytest.raises(OSError, match="action failed"):
        trig.flush()
    assert seen[-1] == 49                    # nothing ran after the error
    trig.close()
    assert not trig._thread.is_alive()


def test_proxy_stats_populated(rt):
    st = rt.proxy_stats()
    assert st["ops_issued"] > 0
    assert st["ops_completed"] > 0
    assert rt.allreduce_max(7) == 7
    rt.barrier()


def test_two_process_ring():
    """acxrun -np 2 python <this file as worker>: tensors across real
    process boundaries."""
    from mpi_acx_torch import runtime
    r = subprocess.run(
        [runtime.acxrun_path(), "-np", "2", "-timeout", "100",
         sys.executable, __file__, "--worker"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TORCH RING OK" in r.stdout


def _worker() -> int:
    sys.path.insert(0, REPO)
    from mpi_acx_torch import runtime
    rt = runtime.Runtime()
    right = (rt.rank + 1) % rt.size
    left = (rt.rank - 1) % rt.size
    src = torch.full((16,), rt.rank * 10, dtype=torch.int32)
    dst = torch.full((16,), -1, dtype=torch.int32)
    s = rt.isend_enqueue(src, dest=right, tag=1)
    rv = rt.irecv_enqueue(dst, source=left, tag=1)
    st = rt.wait(rv)
    rt.wait(s)
    bsrc = torch.full((5,), 0.5 + rt.rank, dtype=torch.bfloat16)
    bdst = torch.zeros(5, dtype=torch.bfloat16)
    s = rt.isend_enqueue(bsrc, dest=right, tag=2)
    rt.wait(rt.irecv_enqueue(bdst, source=left, tag=2))
    rt.wait(s)
    errs = int(not bool((dst == left * 10).all()) or st.MPI_SOURCE != left
               or not bool((bdst == 0.5 + left).all()))
    errs = rt.allreduce_max(errs)
    if rt.rank == 0 and errs == 0:
        print("TORCH RING OK")
    rt.finalize()
    return errs


if __name__ == "__main__" and "--worker" in sys.argv:
    raise SystemExit(_worker())
