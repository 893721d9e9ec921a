"""A planted fault in the decode merge, to show that chip_smoke's phase 2
sees it: copies mpi_acx_torch/csrc/ to build/probes/mutant/csrc, makes
chunk 0's merge skip the last live chunk, builds that copy into a build
directory of its own and runs chip_smoke.phase_kernels on it. Exits 0 when
phase 2 fails (the fault is caught; the case and its error are the last
"kernel ..." line printed), 1 when it passes.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/decode_mutant.py``."""
import os
import re
import shutil
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
from mpi_acx_torch.ops import _build  # noqa: E402

src = Path("build/probes/mutant/csrc")
shutil.rmtree(src, ignore_errors=True)
shutil.copytree(_build.CSRC, src)
cu = (src / "flash_decode.cu").read_text()
old = "for (int c = 1; c < n_live; ++c) {"
assert cu.count(old) == 1, "merge loop not found"
(src / "flash_decode.cu").write_text(cu.replace(
    old, "for (int c = 1; c < n_live - 1; ++c) {"))
_build.CSRC = src.resolve()
_build.BUILD_DIR = Path("build/probes/mutant/lib").resolve()
import chip_smoke as cs  # noqa: E402

cs.phase_build()
try:
    cs.phase_kernels()
except SystemExit:
    print("MUTANT CAUGHT", flush=True)
    sys.exit(0)
print("MUTANT NOT CAUGHT", flush=True)
sys.exit(1)
