"""Where a decode call's time goes, per CTA: a copy of
mpi_acx_torch/csrc/flash_decode.cu with timestamps added (built apart into
build/probes/trace, the sources in the package untouched) records clock64
at entry, once pos is read, once tile 0 has landed, after the tile loop,
after chunk 0's wait (or a sibling's cluster wait) and at the end, and
globaltimer at entry and end. K2 bf16 at the phase-4 decode shape (served
positions) and with every slot at its last row, for 128, 256 and 1024
positions a CTA; prints the medians and maxima per kind of CTA (direct,
sender, merger).

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/decode_trace.py``."""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mpi_acx_torch.ops import _build, flash_decode as fd  # noqa: E402

s = (_build.CSRC / "flash_decode.cu").read_text()


def rep(old, new):
    global s
    assert old in s, old
    s = s.replace(old, new, 1)


rep('#include "common.cuh"\n', '''#include "common.cuh"
__device__ unsigned long long g_trace[8192][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}
extern "C" int acx_trace_read(void* host) {
  return cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
extern "C" int acx_trace_clear() {
  void* p;
  cudaGetSymbolAddress(&p, g_trace);
  return cudaMemset(p, 0, sizeof(g_trace));
}
#define TRACE(kind) if (tid == 0) { \\
  unsigned long long* tr = g_trace[blockIdx.x + gridDim.x * (blockIdx.y + \\
      gridDim.y * blockIdx.z)]; \\
  const unsigned long long TE = clock64(); \\
  tr[0] = G0; tr[1] = T1 - T0; tr[2] = T2 - T0; tr[3] = T3 - T0; \\
  tr[4] = T4 - T0; tr[5] = TE - T0; \\
  tr[6] = smid() | (n_live << 8) | (chunk << 16) | ((kind) << 24); \\
  tr[7] = gtime(); }
''')
rep("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
    "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
    "  const unsigned long long T0 = clock64(), G0 = gtime();\n"
    "  unsigned long long T2 = 0, T3 = 0, T4 = 0;\n")
rep("  const int c_lo = chunk * a.chunk,",
    "  const unsigned long long T1 = clock64();\n"
    "  const int c_lo = chunk * a.chunk,")
rep("    cp_async_wait_ring(S);\n    __syncthreads();\n",
    "    cp_async_wait_ring(S);\n    __syncthreads();\n"
    "    if (tt == 0) T2 = clock64();\n")
rep("  // Merge the warps' states in warp order",
    "  T3 = clock64();\n  // Merge the warps' states in warp order")
rep("  else if (n_live > 1) mbar_wait0(&bar);      // the partials are in\n",
    "  else if (n_live > 1) mbar_wait0(&bar);      // the partials are in\n"
    "  T4 = clock64();\n")
LAUNCH = ("template <typename T, typename KT, int R, bool PAGED>\n"
          "cudaError_t launch(")
rep("  }\n}\n\n" + LAUNCH,
    "  }\n  TRACE(chunk > 0 ? 2 : (n_live > 1 ? 3 : 1));\n}\n\n" + LAUNCH)

d = Path("build/probes/trace")
d.mkdir(parents=True, exist_ok=True)
(d / "flash_decode.cu").write_text(s)
(d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(d / "flash_decode.cu"), "-o", str(d / "lib.so")],
                   capture_output=True, text=True)
if r.returncode:
    print(r.stdout[-3000:], r.stderr[-3000:])
    sys.exit(1)
lib = ctypes.CDLL(str(d / "lib.so"))
pv, iv = ctypes.c_void_p, ctypes.c_int
lib.acx_flash_decode.argtypes = [pv] * 7 + [iv] * 9 + [
    ctypes.POINTER(ctypes.c_longlong), pv]
lib.acx_flash_decode.restype = iv
lib.acx_trace_read.argtypes = [pv]
_build._lib = lib

card = cs.card()
print(card, subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
gen = torch.Generator(device="cuda").manual_seed(3)
B, max_len, L, H, D = 8, 1024, 12, 12, 64
q = cs.randn((B, 1, H, D), torch.bfloat16, gen)
kc = cs.randn((L, B, max_len, H, D), torch.bfloat16, gen)
vc = cs.randn((L, B, max_len, H, D), torch.bfloat16, gen)
buf = np.zeros((8192, 8), np.uint64)
rule = fd.decode_chunk
for label, p in (("served", [40, 160, 320, 528] * 2), ("full", [1023] * 8)):
    pos = torch.tensor(p, dtype=torch.int32, device="cuda")
    for c in (128, 256, 1024):
        fd.decode_chunk = lambda *_, c=c: c
        for i in range(12):          # warm, and push other layers from L2
            fd.flash_decode_attend(q, kc[i], vc[i], pos, max_len, 1)
        torch.cuda.synchronize()
        lib.acx_trace_clear()
        torch.cuda.synchronize()
        fd.flash_decode_attend(q, kc[5], vc[5], pos, max_len, 1)
        torch.cuda.synchronize()
        lib.acx_trace_read(buf.ctypes.data)
        t = buf[buf[:, 0] > 0].astype(np.int64)
        g0 = t[:, 0].min()
        kind = (t[:, 6] >> 24) & 0xff
        print(f"TRACE {label} chunk {c}: {len(t)} CTAs with work, span "
              f"{(t[:, 7].max() - g0) / 1e3:.2f} us (globaltimer), entry "
              f"stagger p50/max {np.median(t[:, 0] - g0) / 1e3:.2f}/"
              f"{(t[:, 0].max() - g0) / 1e3:.2f} us, SMs used "
              f"{len(set((t[:, 6] & 0xff).tolist()))}", flush=True)
        for k, name in ((1, "direct"), (2, "sender"), (3, "merger")):
            sel = t[kind == k]
            if not len(sel):
                continue
            cols = ["pos", "tile0", "loop", "waited", "end"]
            stats = []
            for j, col in enumerate(cols, start=1):
                v = sel[:, j]
                v = v[v > 0] if col == "waited" else v
                if len(v):
                    stats.append(f"{col} {int(np.median(v))}/{int(v.max())}")
            print(f"TRACE   {name} x{len(sel)} cycles from entry p50/max: "
                  + ", ".join(stats) + "; end (gt) p50/max "
                  f"{np.median(sel[:, 7] - g0) / 1e3:.2f}/"
                  f"{(sel[:, 7].max() - g0) / 1e3:.2f} us", flush=True)
fd.decode_chunk = rule
