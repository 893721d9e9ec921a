"""Hygiene of the PyTorch port (mpi_acx_torch) and its chip smoke script.

The port imports nothing of JAX or of mpi_acx_tpu, does not touch CUDA at
import, runs its entry points on the GPU unless told otherwise (and raises
rather than drifting onto the CPU when there is none), counts kernel
launches only where a kernel launches, and builds its kernels for sm_90a.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt
from mpi_acx_torch.ops import _build
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.ops import flash_decode as tfd

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mpi_acx_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    assert len(PORT_FILES) >= 12
    bad = [(p.relative_to(ROOT), m) for p in PORT_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "mpi_acx_tpu")]
    assert not bad, bad


def test_import_loads_neither_jax_nor_cuda():
    code = (
        "import sys, torch, mpi_acx_torch\n"
        "from mpi_acx_torch import device, reqlog, runtime, triggers\n"
        "from mpi_acx_torch.models import decoding, serving, transformer\n"
        "from mpi_acx_torch.ops import _build, attention, flags, "
        "flash_decode\n"
        "import mpi_acx_torch.models as m; m.serve_greedy; m.gpt2_small\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'mpi_acx_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libtpuacx' not in maps and 'libacx_torch' not in maps\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def _tiny():
    cfg = tt.tiny_config(vocab=31, d_model=32, n_heads=2, n_layers=1,
                         d_ff=64, max_seq=32)
    return cfg, tt.init_params(cfg, seed=0, device="cpu")


ENTRY_POINTS = {
    "init_params": lambda cfg, p: tt.init_params(cfg, 0),
    "params_from_jax": lambda cfg, p: tt.params_from_jax(
        {"embed": np.zeros((2, 2), np.float32)}),
    "init_kv_cache": lambda cfg, p: tt.init_kv_cache(cfg, 1, 8),
    "generate": lambda cfg, p: tt.generate(p, cfg, np.zeros((1, 3),
                                                            np.int32), 2),
    "serve_greedy": lambda cfg, p: ts.serve_greedy(
        p, cfg, [np.arange(3, dtype=np.int32)], 2, n_slots=1, max_len=8),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    """device=None means the GPU; with no GPU the call raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](cfg, params)


def test_params_on_another_device_are_refused():
    cfg, params = _tiny()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in params.items()}
    with pytest.raises(ValueError, match="params are on"):
        tt.generate(meta, cfg, np.zeros((1, 3), np.int32), 2, device="cpu")


def test_cpu_tensors_leave_launch_counts_at_zero():
    tattn.flash_attention.launches = 0
    tfd.flash_decode_attend.launches = 0
    cfg, params = _tiny()
    out = ts.serve_greedy(params, cfg, [np.arange(5, dtype=np.int32)] * 3,
                          4, n_slots=2, max_len=16, device="cpu")
    assert len(out) == 3
    assert tattn.flash_attention.launches == 0
    assert tfd.flash_decode_attend.launches == 0


def test_nvcc_commands_target_sm90a():
    compiles, link = _build.nvcc_commands("nvcc", Path("/x"), ".1")
    assert len(compiles) == len(_build.SOURCES) == 3
    for cmd in compiles + [link]:
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        assert "-O3" in cmd and "-std=c++17" in cmd
    assert "-shared" in link and link[-1].endswith(_build.LIB_NAME + ".1")
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    assert len(_build.sources_hash()) == 64


def test_native_library_is_loaded_rtld_local():
    """The native library defines host shims under the CUDA runtime's names
    (src/runtime/cuda_shim.cc): loaded RTLD_LOCAL after torch, none of its
    symbols enters the process's global scope, so neither it nor PyTorch's
    CUDA runtime binds to the other's."""
    subprocess.run(["make", "-C", str(ROOT), "lib", "tools"], check=True,
                   capture_output=True, timeout=600)
    code = (
        "import ctypes, os, torch\n"
        "from mpi_acx_torch import runtime\n"
        "assert runtime.DLOPEN_MODE & os.RTLD_GLOBAL == 0\n"
        "L = runtime.lib()\n"
        "assert L.acx_flags_publish and L.cudaLaunchHostFunc\n"
        "glob = ctypes.CDLL(None)\n"
        "for name in ('acx_flags_publish', 'MPIX_Init', "
        "'cudaLaunchHostFunc'):\n"
        "    assert not hasattr(glob, name), name\n"
        "print('local')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "local" in res.stdout, res.stderr


def test_dtype_codes():
    assert _build.dtype_code(torch.float32) == 0
    assert _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=180,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
