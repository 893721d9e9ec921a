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

from mpi_acx_torch import data as tdata
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import disagg as tdg
from mpi_acx_torch.models import kvpage as tkp
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import moe as tmoe
from mpi_acx_torch.models import moe_transformer as tmt
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import speculative as tsp
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
    assert len(PORT_FILES) >= 30
    for name in ("llama.py", "moe.py", "moe_transformer.py",
                 "speculative.py"):
        assert ROOT / "mpi_acx_torch" / "models" / name in PORT_FILES
    for name in ("data.py", "checkpoint.py", "profiling.py"):
        assert ROOT / "mpi_acx_torch" / name in PORT_FILES
    for name in ("models/disagg.py", "parallel/kv_ship.py",
                 "parallel/multihost.py", "parallel/quantized.py"):
        assert ROOT / "mpi_acx_torch" / name in PORT_FILES
    bad = [(p.relative_to(ROOT), m) for p in PORT_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "mpi_acx_tpu")]
    assert not bad, bad


def test_import_loads_neither_jax_nor_cuda():
    code = (
        "import sys, torch, mpi_acx_torch\n"
        "from mpi_acx_torch import checkpoint, data, device, profiling, "
        "reqlog, runtime, train, triggers\n"
        "from mpi_acx_torch.models import decoding, disagg, kvpage, llama, "
        "moe, moe_transformer, serving, speculative, transformer\n"
        "from mpi_acx_torch.ops import _build, attention, flags, "
        "flash_decode, kvquant, wquant, xent\n"
        "from mpi_acx_torch.parallel import collective, kv_ship, mesh, "
        "pipeline, ring_attention\n"
        "import mpi_acx_torch.models as m; m.serve_greedy; m.gpt2_small\n"
        "m.serve_paged_greedy; m.PagedKV; m.kvpage\n"
        "m.serve_disagg_greedy; m.disagg\n"
        "m.llama3_8b; m.LlamaConfig; m.llama\n"
        "m.MoeConfig; m.MoeTransformerConfig; m.tiny_moe_config; "
        "m.moe_transformer\n"
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
    "serve_paged_greedy": lambda cfg, p: ts.serve_paged_greedy(
        p, cfg, [np.arange(3, dtype=np.int32)], 2, n_slots=1, max_len=8),
    "init_page_pool": lambda cfg, p: tkp.init_page_pool(cfg, 2, 4, 1),
    "PagedKV": lambda cfg, p: tkp.PagedKV(cfg, tt, 1, 8, 4, 2),
    "make_loss_and_grads": lambda cfg, p: ttrain.make_loss_and_grads(
        cfg, _mesh(), 1),
    "make_train_step": lambda cfg, p: ttrain.make_train_step(cfg, _mesh(),
                                                             1),
    "make_train_step_optim": lambda cfg, p: ttrain.make_train_step_optim(
        cfg, _mesh(), 1, torch.optim.SGD([torch.zeros(1)], lr=0.1)),
    "llama.init_params": lambda cfg, p: tl.init_params(_tiny_llama(), 0),
    "llama.params_from_jax": lambda cfg, p: tl.params_from_jax(
        {"embed": np.zeros((2, 2), np.float32)}),
    "llama.init_kv_cache": lambda cfg, p: tl.init_kv_cache(_tiny_llama(),
                                                           1, 8),
    "llama.generate": lambda cfg, p: tl.generate(
        _llama_params(), _tiny_llama(), np.zeros((1, 3), np.int32), 2),
    "llama.serve_greedy": lambda cfg, p: ts.serve_greedy(
        _llama_params(), _tiny_llama(), [np.arange(3, dtype=np.int32)], 2,
        n_slots=1, max_len=8, family=tl),
    "moe.init_moe_params": lambda cfg, p: tmoe.init_moe_params(
        tmoe.MoeConfig(d_model=8, d_ff=8, n_experts=2)),
    "moe_transformer.init_params": lambda cfg, p: tmt.init_params(
        _tiny_moe(), 0),
    "moe_transformer.init_kv_cache": lambda cfg, p: tmt.init_kv_cache(
        _tiny_moe(), 1, 8),
    "moe_transformer.generate": lambda cfg, p: tmt.generate(
        _moe_params(), _tiny_moe(), np.zeros((1, 3), np.int32), 2),
    "moe_transformer.serve_greedy": lambda cfg, p: ts.serve_greedy(
        _moe_params(), _tiny_moe(), [np.arange(3, dtype=np.int32)], 2,
        n_slots=1, max_len=8, family=tmt),
    "moe_transformer.make_train_step": lambda cfg, p:
        ttrain.make_train_step(_tiny_moe(), _mesh(), 1),
    "prefetch": lambda cfg, p: tdata.prefetch(iter([])),
    "generate_sample": lambda cfg, p: tt.generate_sample(
        p, cfg, np.zeros((1, 3), np.int32), 2, torch.Generator()),
    "llama.generate_sample": lambda cfg, p: tl.generate_sample(
        _llama_params(), _tiny_llama(), np.zeros((1, 3), np.int32), 2,
        torch.Generator()),
    "moe_transformer.generate_sample": lambda cfg, p: tmt.generate_sample(
        _moe_params(), _tiny_moe(), np.zeros((1, 3), np.int32), 2,
        torch.Generator()),
    "serve_sample": lambda cfg, p: ts.serve_sample(
        p, cfg, [np.arange(3, dtype=np.int32)], 2, n_slots=1, max_len=8,
        key=0),
    "speculative_generate": lambda cfg, p: tsp.speculative_generate(
        p, cfg, p, cfg, np.zeros((1, 3), np.int32), 2),
    "speculative_sample": lambda cfg, p: tsp.speculative_sample(
        p, cfg, p, cfg, np.zeros((1, 3), np.int32), 2, torch.Generator()),
    "serve_disagg_greedy": lambda cfg, p: tdg.serve_disagg_greedy(
        p, cfg, [np.arange(3, dtype=np.int32)], 2, n_slots=1, max_len=8),
    "run_prefill_worker": lambda cfg, p: tdg.run_prefill_worker(
        None, p, cfg, [np.arange(3, dtype=np.int32)], 8),
    "run_decode_worker": lambda cfg, p: tdg.run_decode_worker(
        None, p, cfg, [np.arange(3, dtype=np.int32)], 2, 1, 8),
}


def _tiny_moe():
    return tmt.tiny_moe_config(vocab=31, d_model=32, n_heads=2, n_layers=1,
                               d_ff=32, n_experts=4, max_seq=32)


def _moe_params():
    return tmt.init_params(_tiny_moe(), seed=0, device="cpu")


def _tiny_llama():
    return tl.tiny_llama(vocab=31, d_model=32, n_heads=4, n_kv_heads=2,
                         n_layers=1, d_ff=64, max_seq=32)


def _llama_params():
    return tl.init_params(_tiny_llama(), seed=0, device="cpu")


def _mesh():
    from mpi_acx_torch.parallel.mesh import mesh_from_devices
    return mesh_from_devices({"dp": 1, "pp": 1, "tp": 1})


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
    counters = [(tattn.flash_attention, "launches"),
                (tfd.flash_decode_attend, "launches"),
                (tfd.flash_decode_attend, "launches_int8"),
                (tfd.paged_flash_decode_attend, "launches"),
                (tfd.paged_flash_decode_attend, "launches_int8")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    cfg, params = _tiny()
    prompts = [np.arange(5, dtype=np.int32)] * 3
    for kv_int8 in (False, True):
        for serve in (ts.serve_greedy, ts.serve_paged_greedy):
            out = serve(params, cfg, prompts, 4, n_slots=2, max_len=16,
                        kv_int8=kv_int8, device="cpu")
            assert len(out) == 3
    for fn, attr in counters:
        assert getattr(fn, attr) == 0, (fn.__name__, attr)


def test_llama_on_cpu_tensors_leaves_launch_counts_at_zero():
    """The Llama family's serving path on the CPU: prefill and decode
    through the plain versions, no launch of any form counted."""
    counters = [(tattn.flash_attention, "launches"),
                (tattn.flash_attention, "launches_d128"),
                (tfd.flash_decode_attend, "launches"),
                (tfd.flash_decode_attend, "launches_int8"),
                (tfd.flash_decode_attend, "launches_d128"),
                (tfd.flash_decode_attend, "launches_int8_d128")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    cfg, params = _tiny_llama(), _llama_params()
    prompts = [np.arange(5, dtype=np.int32)] * 3
    for kv_int8 in (False, True):
        out = ts.serve_greedy(params, cfg, prompts, 4, n_slots=2,
                              max_len=16, kv_int8=kv_int8, family=tl,
                              device="cpu")
        assert len(out) == 3
    for fn, attr in counters:
        assert getattr(fn, attr) == 0, (fn.__name__, attr)


def test_sampling_and_speculation_on_cpu_leave_launch_counts_at_zero():
    """serve_sample and both speculative loops (Llama's window pass runs
    the decode attention with W = k) on the CPU: the plain versions run,
    no launch of any form is counted."""
    counters = [(tattn.flash_attention, "launches"),
                (tattn.flash_attention, "launches_d128"),
                (tfd.flash_decode_attend, "launches"),
                (tfd.flash_decode_attend, "launches_int8"),
                (tfd.flash_decode_attend, "launches_d128"),
                (tfd.flash_decode_attend, "launches_int8_d128")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    cfg, params = _tiny_llama(), _llama_params()
    prompts = [np.arange(5, dtype=np.int32)] * 3
    out = ts.serve_sample(params, cfg, prompts, 4, n_slots=2, max_len=16,
                          key=1, family=tl, kv_int8=True, device="cpu")
    assert len(out) == 3
    prompt = np.zeros((2, 4), np.int32)
    tsp.speculative_generate(params, cfg, params, cfg, prompt, 6,
                             device="cpu")
    tsp.speculative_sample(params, cfg, params, cfg, prompt, 6,
                           torch.Generator(), device="cpu")
    for fn, attr in counters:
        assert getattr(fn, attr) == 0, (fn.__name__, attr)


def test_moe_on_cpu_tensors_leaves_launch_counts_at_zero():
    """The MoE family's serving and training paths on the CPU: the plain
    versions run, no launch of any form is counted."""
    counters = [(tattn.flash_attention, "launches"),
                (tattn.flash_attention_lse, "launches"),
                (tfd.flash_decode_attend, "launches"),
                (tfd.flash_decode_attend, "launches_int8")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    cfg, params = _tiny_moe(), _moe_params()
    prompts = [np.arange(5, dtype=np.int32)] * 3
    for kv_int8 in (False, True):
        out = ts.serve_greedy(params, cfg, prompts, 4, n_slots=2,
                              max_len=16, kv_int8=kv_int8, family=tmt,
                              device="cpu")
        assert len(out) == 3
    step, _ = ttrain.make_train_step(cfg, _mesh(), 1, device="cpu")
    tokens = np.arange(16, dtype=np.int32).reshape(1, 2, 8)
    step(tt.stage_slice(params, 1), tokens, tokens)
    for fn, attr in counters:
        assert getattr(fn, attr) == 0, (fn.__name__, attr)


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


@pytest.mark.parametrize("module", ["data", "checkpoint", "profiling"])
def test_entry_modules_keep_the_jax_names_and_signatures(module):
    """data, checkpoint and profiling define every public name of their
    JAX counterparts, each function and method with JAX's parameters;
    ``prefetch`` alone takes ``device`` where JAX takes ``sharding``."""
    import importlib
    import inspect
    tree = ast.parse((ROOT / "mpi_acx_tpu" / f"{module}.py").read_text())
    port = importlib.import_module(f"mpi_acx_torch.{module}")
    want, got = {}, {}

    def names(fn):
        a = fn.args
        out = [x.arg for x in a.posonlyargs + a.args]
        out += [a.vararg.arg] if a.vararg else []
        return out + [x.arg for x in a.kwonlyargs]

    def raw(obj):
        return getattr(obj, "__func__", obj)   # classmethod, staticmethod

    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                node.name.startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            want[node.name] = names(node)
            got[node.name] = list(inspect.signature(
                getattr(port, node.name)).parameters)
            continue
        cls = getattr(port, node.name)
        for m in node.body:
            if isinstance(m, ast.FunctionDef) and (
                    not m.name.startswith("_") or m.name in (
                        "__init__", "__enter__", "__exit__")):
                qual = f"{node.name}.{m.name}"
                want[qual] = names(m)
                got[qual] = list(inspect.signature(raw(
                    inspect.getattr_static(cls, m.name))).parameters)
    if module == "data":
        want["prefetch"] = ["it", "size", "device"]
    assert want and got == want
