"""K2 at the phase-4 decode shape (bf16, B = 8, W = 1, served positions)
from the mpi_acx_torch package under the directory given as the argument
(this checkout, ".", or another one, e.g. a ``git archive`` of an earlier
commit unpacked into build/): the wrapper's host cost per call (three
eager loops of 500 calls, host clock, no synchronize), the C entry's alone
(2000 calls with the arguments made once) and the device time per call
(CUDA-graph replay), as one ``HOSTAB`` JSON line. Compare two trees on one
machine, in turns: A, B, B, A.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/decode_ab.py <tree>``."""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch  # noqa: E402
from mpi_acx_torch.ops import _build, flash_decode as fd  # noqa: E402

_build.BUILD_DIR = _build.Path(root) / "build" / "torch_kernels"
assert fd.__file__.startswith(root), fd.__file__
sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

gen = torch.Generator(device="cuda").manual_seed(3)
B, max_len, L, H, D = 8, 1024, 12, 12, 64
q = cs.randn((B, 1, H, D), torch.bfloat16, gen)
kc = cs.randn((L, B, max_len, H, D), torch.bfloat16, gen)
vc = cs.randn((L, B, max_len, H, D), torch.bfloat16, gen)
pos = torch.tensor([40, 160, 320, 528] * 2, dtype=torch.int32, device="cuda")
for i in range(20):
    fd.flash_decode_attend(q, kc[i % L], vc[i % L], pos, max_len, 1)
torch.cuda.synchronize()
host = []
for _ in range(3):
    n = 500
    t0 = time.perf_counter()
    for k in range(n):
        fd.flash_decode_attend(q, kc[k % L], vc[k % L], pos, max_len, 1)
    host.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
# The C entry alone, its arguments made once (the launch's host cost).
lib = _build.lib()
out = torch.empty((B, 1, H * D), dtype=q.dtype, device="cuda")
k, v = kc[0], vc[0]
st = _build.strides(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), 0, 0, 0, 0)
stream = _build.stream_handle(q.device)
args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, pos.data_ptr(),
        out.data_ptr(), 1, 0, B, 1, H, 1, D, max_len]
if len(lib.acx_flash_decode.argtypes) == 18:
    args.append(fd.decode_chunk(B, H, 1, max_len, cs.sm_count()))
args += [st, stream]
n = 2000
t0 = time.perf_counter()
for _ in range(n):
    assert lib.acx_flash_decode(*args) == 0
c_us = (time.perf_counter() - t0) / n * 1e6
torch.cuda.synchronize()
it = iter(range(10 ** 9))
dev = cs.time_ms(lambda: fd.flash_decode_attend(
    q, kc[next(it) % L], vc[next(it) % L], pos, max_len, 1), 240)
print("HOSTAB " + json.dumps({"tree": sys.argv[1], "host_us": host,
                              "c_entry_us": c_us, "device_ms": dev,
                              "card": cs.card()}),
      flush=True)
