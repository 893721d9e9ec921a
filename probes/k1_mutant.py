"""A planted fault in K1 at head dim 128, to show that chip_smoke sees it:
copies mpi_acx_torch/csrc/ to build/probes/k1_mutant/csrc, plants the
fault in the copy, builds it into a build directory of its own and runs
the chip_smoke phase that must catch it. Two faults:

* ``scale`` (the default): the D = 128 instantiations take D = 64's scale
  (no q * 1/sqrt(128) in shared memory; the exponent folded with 1/8
  instead); phase 2 (``phase_kernels``) must fail.
* ``lse``: B10's lse at D = 128 written with D = 64's ``m * 0.125f``
  although m is already in scaled units there; phase 2b
  (``phase_train_kernels``) must fail.

Exits 0 when the phase fails (the fault is caught; the case and its error
are the last "kernel ..." line printed), 1 when it passes.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/k1_mutant.py [scale|lse]``."""
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
from mpi_acx_torch.ops import _build  # noqa: E402

FAULTS = {
    "scale": ("constexpr bool kFold = D == 64;",
              "constexpr bool kFold = true;", "phase_kernels"),
    "lse": ("constexpr float mscale = kFold ? 0.125f : 1.f;",
            "constexpr float mscale = 0.125f;", "phase_train_kernels"),
}
fault = sys.argv[1] if len(sys.argv) > 1 else "scale"
old, new, phase = FAULTS[fault]
root = Path("build/probes/k1_mutant") / fault
src = root / "csrc"
shutil.rmtree(src, ignore_errors=True)
shutil.copytree(_build.CSRC, src)
cu = (src / "flash_attention.cu").read_text()
assert cu.count(old) == 1, f"the {fault} fault's line not found"
(src / "flash_attention.cu").write_text(cu.replace(old, new))
_build.CSRC = src.resolve()
_build.BUILD_DIR = (root / "lib").resolve()
import chip_smoke as cs  # noqa: E402

cs.phase_build()
try:
    getattr(cs, phase)()
except SystemExit:
    print(f"MUTANT CAUGHT ({fault}, {phase})", flush=True)
    sys.exit(0)
print(f"MUTANT NOT CAUGHT ({fault}, {phase})", flush=True)
sys.exit(1)
