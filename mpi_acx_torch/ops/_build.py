"""Build and load the port's hand-written CUDA kernels.

The sources in ``mpi_acx_torch/csrc/`` expose plain C entry points, so they
are compiled with ``nvcc`` alone (no PyTorch headers: seconds, not minutes)
into ``build/torch_kernels/libacx_torch_kernels.so`` and loaded with
``ctypes``. Each source compiles in its own ``nvcc`` process, all started
together, and the objects are linked into one library. The library is
rebuilt whenever the sources' hash changes; nothing here runs at import
time, so the CPU-only test box imports every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_decode.cu", "flags.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libacx_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location. Raises when neither exists."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on the machine with the GPU")
    return nvcc


def sources_hash() -> str:
    """Hash of every kernel source, header and the compile flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def nvcc_commands(nvcc: str = "nvcc", build_dir: Path = BUILD_DIR,
                  tag: str = "") -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command). ``tag``
    keeps concurrent builds' intermediate files apart."""
    objs = [build_dir / f"{Path(s).stem}{tag}.o" for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                for s, o in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
            str(build_dir / f"{LIB_NAME}{tag}")]
    return compiles, link


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless the
    library on disk was built from the same sources. Returns its path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = sources_hash()
    if (lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}"
    compiles, link = nvcc_commands(find_nvcc(), BUILD_DIR, tag)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in compiles]
    outs = [p.communicate() for p in procs]     # waits for every compile
    for cmd, p, (out, _) in zip(compiles, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(link)}\n{res.stdout}")
    os.replace(BUILD_DIR / f"{LIB_NAME}{tag}", lib_path)
    stamp.write_text(digest + "\n")
    for c in compiles:
        Path(c[-1]).unlink(missing_ok=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        so.acx_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, s,
                                           i, i, p]
        so.acx_flash_attention.restype = i
        so.acx_flash_attention_lse.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, s, i, i, p]
        so.acx_flash_attention_lse.restype = i
        so.acx_flash_decode.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, i, i, i, s, p]
        so.acx_flash_decode.restype = i
        so.acx_paged_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                        i, i, i, i, i, i, i, s, p]
        so.acx_paged_decode.restype = i
        so.acx_flags_pready.argtypes = [p, i, p, i, i, p]
        so.acx_flags_pready.restype = i
        so.acx_flags_parrived.argtypes = [p, i, p, i, i, p, p]
        so.acx_flags_parrived.restype = i
        f = ctypes.c_float
        so.acx_flags_produce_and_pready.argtypes = [
            p, p, ctypes.c_longlong, i, f, f, p, i, p, i, p, p]
        so.acx_flags_produce_and_pready.restype = i
        _lib = so
    return _lib


def strides(*values: int):
    """A C array of element strides for the entry points."""
    return (ctypes.c_longlong * len(values))(*values)


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as the C entry points
    take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # common.cuh kF32/kBF16


def dtype_code(dtype) -> int:
    """The C entry points' dtype code for a torch dtype; raises for a dtype
    the kernels do not take."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]
