"""A planted fault in K1 at head dim 128, to show that chip_smoke's phase 2
sees it: copies mpi_acx_torch/csrc/ to build/probes/k1_mutant/csrc, makes
the D = 128 instantiations take D = 64's scale (no q * 1/sqrt(128) in
shared memory; the exponent folded with 1/8 instead), builds that copy
into a build directory of its own and runs chip_smoke.phase_kernels on it.
Exits 0 when phase 2 fails (the fault is caught; the case and its error are
the last "kernel ..." line printed), 1 when it passes.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/k1_mutant.py``."""
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
from mpi_acx_torch.ops import _build  # noqa: E402

src = Path("build/probes/k1_mutant/csrc")
shutil.rmtree(src, ignore_errors=True)
shutil.copytree(_build.CSRC, src)
cu = (src / "flash_attention.cu").read_text()
old = "constexpr bool kFold = D == 64;"
assert cu.count(old) == 1, "the scale's switch not found"
(src / "flash_attention.cu").write_text(cu.replace(
    old, "constexpr bool kFold = true;"))
_build.CSRC = src.resolve()
_build.BUILD_DIR = Path("build/probes/k1_mutant/lib").resolve()
import chip_smoke as cs  # noqa: E402

cs.phase_build()
try:
    cs.phase_kernels()
except SystemExit:
    print("MUTANT CAUGHT", flush=True)
    sys.exit(0)
print("MUTANT NOT CAUGHT", flush=True)
sys.exit(1)
