"""Whether NCCL takes two ranks on one card: the question that decides the
wire of chip_smoke.py's phase 7c (eight ranks sharing one GPU).

Starts two processes of itself, which join through a ``file://``
rendezvous under build/ with ``multihost.initialize(backend="nccl")``
(each bound to card ``rank % device_count``, the communicator built at
once) and then run one ``all_reduce`` of a CUDA tensor. Each prints a
``NCCL_ONE_CARD rank=R ok=... message=...`` line: what NCCL said, or the
sum it returned. Exits 0 either way; the lines are the finding.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/nccl_one_card.py``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rank_main():
    import torch
    import torch.distributed as dist
    from mpi_acx_torch.parallel import multihost
    rank = int(os.environ["ACX_PROC_ID"])
    try:
        multihost.initialize(backend="nccl", timeout_s=60)
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        msg, ok = f"all_reduce gave {x.tolist()}", True
    except Exception as e:          # the finding is the message
        msg, ok = f"{type(e).__name__}: {e}", False
    one_line = " ".join(msg.split())[:600]
    print(f"NCCL_ONE_CARD rank={rank} ok={ok} message={one_line}",
          flush=True)
    os._exit(0)     # skip teardown: a half-built communicator may hang it


def main():
    if os.environ.get("ACX_PROC_ID") is not None:
        return rank_main()
    rdv = ROOT / "build" / "nccl_one_card.rdv"
    rdv.parent.mkdir(exist_ok=True)
    if rdv.exists():
        rdv.unlink()
    env = dict(os.environ, ACX_COORDINATOR=f"file://{rdv}", ACX_NPROCS="2")
    procs = [subprocess.Popen([sys.executable, __file__],
                              env=dict(env, ACX_PROC_ID=str(r)))
             for r in range(2)]
    for p in procs:
        try:
            p.wait(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            print("NCCL_ONE_CARD a rank hung past 180 s and was killed",
                  flush=True)
    rdv.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
