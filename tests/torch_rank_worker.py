"""One rank of a multi-rank job of the port (mpi_acx_torch) over
torch.distributed: the rank program of the multi-rank tests and of
chip_smoke.py's phase 7c.

    ACX_COORDINATOR=file://$PWD/build/rdv ACX_NPROCS=8 ACX_PROC_ID=<r> \\
        python tests/torch_rank_worker.py CASE --out DIR [--device cpu|cuda]
        [--backend gloo|nccl] [--family gpt2|llama|moe]

(or under ``build/acxrun -np N``, which sets ACX_SIZE / ACX_RANK). The
rank calls ``multihost.initialize()``, runs CASE on inputs drawn from
numpy seeds (every rank draws the global array and takes its own block),
and writes ``DIR/CASE.rank<R>.pt``, a dict of its results, which the test
process holds against the JAX package. The ``smoke`` case (GPT-2 124M
at full width on a 2x2x2 mesh) also prints one ``RANK_RUN {json}`` record
per run. :func:`launch` starts a job of N such processes with a wall
timeout (the tests' launcher).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_acx_torch.parallel import collective as col  # noqa: E402
from mpi_acx_torch.parallel import multihost  # noqa: E402
from mpi_acx_torch.parallel.mesh import (  # noqa: E402
    make_mesh, mesh_from_devices)

WORKER = Path(__file__).resolve()
MESH3 = {"dp": 2, "pp": 2, "tp": 2}


def launch(case, n, out_dir, *args, timeout=240, env=None):
    """Run ``case`` on ``n`` ranks of this program (gloo, a ``file://``
    rendezvous under ``out_dir``, one intra-op thread a rank). Every rank
    must exit 0 within ``timeout`` seconds (all are killed otherwise).
    Returns their result dicts in rank order."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rdv = out_dir / f"{case}.rdv"
    if rdv.exists():
        rdv.unlink()
    base = dict(os.environ, ACX_COORDINATOR=f"file://{rdv}",
                ACX_NPROCS=str(n), OMP_NUM_THREADS="1",
                **(env or {}))
    procs = []
    for r in range(n):
        log = open(out_dir / f"{case}.rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), case, "--out", str(out_dir),
             "--dump-after", str(max(1, timeout - 10)), *map(str, args)],
            env=dict(base, ACX_PROC_ID=str(r)),
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
           if p.returncode != 0]
    if bad:
        logs = "\n".join(
            f"--- rank {r} (exit {rc}) ---\n"
            + (out_dir / f"{case}.rank{r}.log").read_text()[-3000:]
            for r, rc in bad)
        raise AssertionError(f"{case}: ranks failed or timed out after "
                             f"{timeout} s: {bad}\n{logs}")
    return [torch.load(out_dir / f"{case}.rank{r}.pt", weights_only=False)
            for r in range(n)]


def start(case, n, out_dir, *args, **kw):
    """:func:`launch` on a thread of its own: a future of its results, so
    that the caller can work meanwhile (on the JAX side, say)."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(launch, case, n, out_dir, *args, **kw)
    pool.shutdown(wait=False)
    return fut


def block(global_array, rank):
    """This rank's block of a [n_ranks, ...] numpy array, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(global_array[rank]))


def rng_array(seed, shape):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# -- collectives -------------------------------------------------------------

MESH_X8 = {"x": 8}
MESH_RC = {"r": 2, "c": 4}

# name -> (mesh, per-rank input shape, the port's per-rank function). The
# tests hold each against the JAX collective of the same name.
COLLECTIVES = {
    "psum_tp": (MESH3, (3, 5), lambda x: col.psum(x, "tp")),
    "psum_pp_tp": (MESH3, (3, 5), lambda x: col.psum(x, ("pp", "tp"))),
    "psum_dp_pp_tp": (MESH3, (4,), lambda x: col.psum(x, ("dp", "pp",
                                                          "tp"))),
    "pmean_dp": (MESH3, (3, 5), lambda x: col.pmean(x, "dp")),
    "all_gather_tiled_tp": (MESH3, (2, 3, 4),
                            lambda x: col.all_gather(x, "tp", axis=1,
                                                     tiled=True)),
    "all_gather_stacked_pp": (MESH3, (2, 3),
                              lambda x: col.all_gather(x, "pp", axis=0)),
    "all_gather_stacked_dp_axis1": (MESH3, (2, 3),
                                    lambda x: col.all_gather(x, "dp",
                                                             axis=1)),
    "ppermute_tp_ring": (MESH3, (2, 3),
                         lambda x: col.ppermute(x, "tp", [(0, 1), (1, 0)])),
    "ppermute_pp_forward": (MESH3, (2, 3),
                            lambda x: col.ppermute(x, "pp", [(0, 1)])),
    "ring_shift_1": (MESH_X8, (2, 3), lambda x: col.ring_shift(x, "x")),
    "ring_shift_-1": (MESH_X8, (2, 3),
                      lambda x: col.ring_shift(x, "x", shift=-1)),
    "ring_shift_3": (MESH_X8, (2, 3),
                     lambda x: col.ring_shift(x, "x", shift=3)),
    "neighbor_exchange": (MESH_X8, (2, 3), lambda x: torch.cat(
        col.neighbor_exchange(x, 2 * x, "x"))),
    "halo_exchange_1d": (MESH_X8, (6, 3),
                         lambda x: col.halo_exchange_1d(x, "x", 2)),
    "halo_exchange_2d": (MESH_RC, (4, 6),
                         lambda x: col.halo_exchange_2d(x, "r", "c", 1)),
    "all_to_all_seq": (MESH_X8, (2, 8, 4),
                       lambda x: col.all_to_all_seq(x, "x", split_axis=1,
                                                    concat_axis=0)),
}


def case_collectives(rank, n, args):
    """Each collective's output and its vjp under a random cotangent."""
    out = {}
    meshes = {}
    for i, (name, (shape, xshape, fn)) in enumerate(COLLECTIVES.items()):
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = mesh_from_devices(shape)
        x = block(rng_array(100 + i, (n,) + xshape), rank).requires_grad_()
        with meshes[key]:
            y = fn(x)
        ct = block(rng_array(200 + i, (n,) + tuple(y.shape)), rank)
        (g,) = torch.autograd.grad(y, x, ct)
        out[name] = dict(y=y.detach(), ct=ct, grad=g)
    # The round trip of all_to_all_seq: sequence-sharded -> head-sharded ->
    # back (tests/test_collective.py's case).
    x = block(np.arange(n * 2 * 8 * 4, dtype=np.float32).reshape(
        n, 2, 8, 4), rank)
    with meshes[tuple(MESH_X8.items())]:
        heads = col.all_to_all_seq(x, "x", split_axis=1, concat_axis=0)
        back = col.all_to_all_seq(heads, "x", split_axis=0, concat_axis=1)
    out["all_to_all_round_trip"] = dict(x=x, heads=heads, back=back)
    # The per-rank wrappers.
    x = block(rng_array(300, (n, 6, 3)), rank)
    m = meshes[tuple(MESH_X8.items())]
    out["ring_shift_sharded"] = col.ring_shift_sharded(x, m)
    out["halo_exchange_1d_sharded"] = col.halo_exchange_1d_sharded(x, m, 2)
    return out


def case_mesh(rank, n, args):
    """Coordinates and line groups of three meshes; the refusal of a mesh
    whose size is not the world's."""
    out = {}
    for label, mesh in (("dp_pp_tp", mesh_from_devices(MESH3)),
                        ("ring", make_mesh()), ("rc", mesh_from_devices(
                            MESH_RC)), ("ones", mesh_from_devices(
                                {"dp": 1, "pp": 1, "tp": 1}))):
        lines = {"/".join(k): v[1] for k, v in mesh._lines.items()}
        with mesh:
            sizes = {a: col.axis_size(a) for a in mesh.shape}
            idx = {a: col.axis_index(a) for a in mesh.shape}
            total = col.psum(torch.tensor(float(rank)),
                             tuple(mesh.shape)).item()
        out[label] = dict(coords=dict(mesh.coords), lines=lines,
                          sizes=sizes, index=idx, rank_sum=total)
    try:
        mesh_from_devices({"x": 4})
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


# -- ring attention ----------------------------------------------------------

RING_MESHES = {2: {"b": 4, "x": 2}, 4: {"b": 2, "x": 4}}
RING_SHAPE = (1, 8, 2, 8)     # per rank [mb, S / n, H, D]


def case_ring(rank, n, args):
    """ring_attention_batched at n = 2 and 4, causal and not, through the
    flash branch (B10's plain version on the CPU) and the dense blocks:
    the output and dq, dk, dv under a random cotangent."""
    from mpi_acx_torch.parallel.ring_attention import (
        ring_attention_batched, ring_attention_sharded)
    out = {}
    for ring, shape in RING_MESHES.items():
        mesh = mesh_from_devices(shape)
        qkv = [block(rng_array(400 + ring * 10 + j, (n,) + RING_SHAPE), rank)
               for j in range(3)]
        ct = block(rng_array(500 + ring, (n,) + RING_SHAPE), rank)
        for causal in (True, False):
            for flash in (True, False):
                xs = [t.clone().requires_grad_() for t in qkv]
                with mesh:
                    y = ring_attention_batched(*xs, "x", causal=causal,
                                               use_flash=flash)
                grads = torch.autograd.grad(y, xs, ct)
                out[(ring, causal, flash)] = dict(
                    y=y.detach(), grads=[g for g in grads])
        # The per-rank wrapper on the 3-D blocks (dense blocks, causal).
        out[("sharded", ring)] = ring_attention_sharded(
            *(t[0] for t in qkv), mesh, "x", causal=True, use_flash=False)
    return out


# -- quantized ---------------------------------------------------------------

QUANT_SHAPES = [(1024,), (4096,), (64, 33), (33,), (3, 5, 11), (1037,)]


def case_quantized(rank, n, args):
    """quantized_psum over dp (n = 2 on the 2x2x2 mesh) and over the
    8-ring, at QUANT_SHAPES and on zeros; ring_psum with raw f32 hops;
    quantized_pmean."""
    from mpi_acx_torch.parallel import quantized as q
    out = {}
    for label, mesh, axis in (("dp", mesh_from_devices(MESH3), "dp"),
                              ("x8", make_mesh(), "x")):
        for i, shape in enumerate(QUANT_SHAPES):
            x = block(rng_array(600 + i, (n,) + shape), rank)
            with mesh:
                out[(label, shape)] = q.quantized_psum(x, axis)
                if i == 0:
                    out[(label, "exact_ring")] = q.ring_psum(
                        x, axis, quantize=False)
                    out[(label, "pmean")] = q.quantized_pmean(x, axis)
                    out[(label, "zeros")] = q.quantized_psum(
                        torch.zeros(2048), axis)
    return out


# -- the train step ----------------------------------------------------------

TRAIN_M, TRAIN_MB, TRAIN_S, VOCAB = 2, 2, 16, 61
AUX_W, Z_W = 0.1, 0.01
TRAIN_OPTIONS = {
    "gpipe": {},
    "virtual2": dict(n_virtual=2),
    "1f1b": dict(schedule="1f1b"),
    "remat": dict(remat=True),
    "quant": dict(dp_quant_bits=8),
}


# family -> (its module's tiny-config maker, the sizes): 4 layers, so 2
# stages of 2 chunks.
TRAIN_SIZES = {
    "gpt2": ("tiny_config", dict(vocab=VOCAB, d_model=32, n_heads=2,
                                 n_layers=4, d_ff=64, max_seq=32)),
    "llama": ("tiny_llama", dict(vocab=VOCAB, d_model=32, n_heads=4,
                                 n_kv_heads=2, n_layers=4, d_ff=64,
                                 max_seq=32)),
    "moe": ("tiny_moe_config", dict(vocab=VOCAB, d_model=32, n_heads=2,
                                    n_layers=4, d_ff=64, n_experts=8,
                                    top_k=2, capacity_factor=1.0,
                                    max_seq=32)),
}


def family_module(family):
    from mpi_acx_torch.models import llama as lm
    from mpi_acx_torch.models import moe_transformer as mt
    from mpi_acx_torch.models import transformer as tfm
    return {"llama": lm, "moe": mt}.get(family, tfm)


def train_config(family):
    """The tiny f32 configuration of ``family``, flash blocks."""
    make, sizes = TRAIN_SIZES[family]
    cfg = getattr(family_module(family), make)(**sizes)
    return dataclasses.replace(cfg, dtype=torch.float32, use_flash=True)


def train_init(family, cfg):
    """The global f32 parameters from seed 0 (unstaged)."""
    return family_module(family).init_params(cfg, seed=0, device="cpu")


def train_batch(m=TRAIN_M, mb=TRAIN_MB, s=TRAIN_S, vocab=VOCAB, seed=1):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (m, mb, s)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=-1)


def staged(params, n_stages, n_virtual):
    from mpi_acx_torch.models import transformer as tfm
    if n_virtual > 1:
        return tfm.stage_slice_interleaved(params, n_stages, n_virtual)
    return tfm.stage_slice(params, n_stages)


def case_train(rank, n, args):
    """Loss and this rank's gradient shards of the 2x2x2 train step under
    each of TRAIN_OPTIONS."""
    from mpi_acx_torch import train
    cfg = train_config(args.family)
    mesh = mesh_from_devices(MESH3)
    tokens, targets = (train.shard_batch(t, mesh) for t in train_batch())
    out = {}
    for name, kw in TRAIN_OPTIONS.items():
        v = kw.get("n_virtual", 1)
        params = train.shard_params(
            staged(train_init(args.family, cfg), 2, v),
            train.step_specs(cfg, v), mesh)
        grad_fn, n_stages = train.make_loss_and_grads(
            cfg, mesh, TRAIN_M, aux_weight=AUX_W, z_weight=Z_W,
            device="cpu", **kw)
        assert n_stages == 2
        loss, grads = grad_fn(params, tokens, targets)
        out[name] = dict(loss=loss.item(), grads=grads)
        print(f"train {args.family} {name}: loss {loss.item():.6f}",
              flush=True)
    return out


def case_multihost(rank, n, args):
    """tests/test_multihost.py's checks on two processes, and a train step
    on a dp = 2 mesh."""
    from mpi_acx_torch import train
    assert multihost.process_count() == 2 and multihost.process_index() \
        == rank
    mesh = multihost.hybrid_mesh({"ici": 1})
    assert mesh.shape == {"dcn": 2, "ici": 1}, mesh.shape
    x = multihost.host_local_to_global(np.arange(4.0) + 10 * rank, mesh,
                                       None)
    with mesh:
        total = col.psum(x.sum(), "dcn").item()
    v = multihost.broadcast_from_host0(
        {"a": np.asarray([41.0 + (1 if rank == 0 else 99)]),
         "b": [torch.tensor([rank + 1.0])]})
    back = multihost.global_to_host_local(x, mesh, None)
    multihost.sync()
    multihost.initialize()          # idempotent
    cfg = train_config("gpt2")
    dmesh = multihost.global_mesh({"dp": 2, "pp": 1, "tp": 1})
    params = train.shard_params(staged(train_init("gpt2", cfg), 1, 1),
                                train.step_specs(cfg), dmesh)
    step, _ = train.make_train_step(cfg, dmesh, TRAIN_M, lr=0.1,
                                    device="cpu")
    batch = [train.shard_batch(t, dmesh) for t in train_batch()]
    losses = [step(params, *batch)[0].item() for _ in range(2)]
    return dict(sum=total, broadcast=v, back=back, losses=losses,
                params=params, replicated=multihost.replicated(mesh),
                budget=multihost.recovery_budget_s(),
                join=multihost.fleet_join_budget_s())


# -- chip_smoke.py phase 7c --------------------------------------------------

SMOKE_M, SMOKE_MB, SMOKE_S = 2, 4, 1024     # phase 5b's batch
SMOKE_LR = 1e-3
SMOKE_STEPS = 3


def ramp_batch(vocab):
    """Phase 5b's ramp task: [M, MB, S] tokens and their next tokens."""
    base = (torch.arange(SMOKE_S)[None, None, :]
            + torch.arange(SMOKE_MB)[None, :, None])
    tokens = (base + torch.arange(SMOKE_M)[:, None, None]) % vocab
    return tokens, torch.roll(tokens, -1, dims=-1)


def b10_counts():
    from mpi_acx_torch.ops.attention import flash_attention_lse
    return flash_attention_lse.launches + flash_attention_lse.launches_d128


def reset_b10():
    from mpi_acx_torch.ops.attention import flash_attention_lse
    flash_attention_lse.launches = flash_attention_lse.launches_d128 = 0


def canonical(spec, mesh):
    """Whether this rank holds the copy of a leaf that the main process
    reads: coordinate 0 on every axis that does not split the leaf."""
    split = {a for a in spec if a is not None}
    return all(c == 0 for a, c in mesh.coords.items() if a not in split)


def save_canonical(path, grads, specs, mesh):
    def pick(tree, sp):
        return {k: pick(v, sp[k]) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()
                if isinstance(v, dict) or canonical(sp[k], mesh)}
    torch.save(pick(grads, specs), path)


def case_smoke(rank, n, args):
    """Phase 7c: GPT-2 124M at full width on the 2x2x2 mesh (``--layers``
    of its 12 layers, all by default), one card shared by all ranks. (a) f32 step 0 under GPipe, (b) the same
    under 1F1B with n_virtual=2, each rank writing the gradient leaves it
    holds the reading copy of; (c) f32 step 0 with dp_quant_bits=8, its
    gradients held here to (a)'s by the JAX package's bounds for the
    quantized sync; (d) bf16 compute on f32 weights, 3 AdamW steps. Each
    run prints a RANK_RUN record (and returns it in ``records``):
    loss(es), B10's launches, ms per step, peak memory, wire bytes per
    axis, backend. The gradients are measured against (a)'s with the
    quantized sync's error over each leaf's max-norm: (c) reports the
    largest max and mean."""
    from mpi_acx_torch import train
    from mpi_acx_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    mesh = multihost.global_mesh(MESH3)
    cfg16 = tfm.gpt2_small()
    if args.layers:
        cfg16 = dataclasses.replace(cfg16, n_layers=args.layers)
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    glob = tfm.init_params(cfg32, seed=0, device="cpu")
    tokens, targets = (train.shard_batch(t, mesh).to(dev)
                       for t in ramp_batch(cfg16.vocab))
    out_dir = Path(args.out)
    backend = torch.distributed.get_backend()

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    def params_for(v):
        specs = train.step_specs(cfg32, v)
        return to_dev(train.shard_params(staged(glob, 2, v), specs,
                                         mesh)), specs

    records = []

    def record(label, **kw):
        rec = dict(rank=rank, run=label, coords=mesh.coords,
                   backend=backend, **kw)
        records.append(rec)
        print("RANK_RUN " + json.dumps(rec), flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        col.WIRE_BYTES.clear()
        reset_b10()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return res, dict(ms=ms, b10=b10_counts(),
                         peak=torch.cuda.max_memory_allocated(),
                         wire={"/".join(k): v
                               for k, v in col.WIRE_BYTES.items()})

    exact = None
    for label, kw in (("f32", {}), ("f32_1f1b_v2",
                                    dict(schedule="1f1b", n_virtual=2)),
                      ("f32_quant", dict(dp_quant_bits=8))):
        params, specs = params_for(kw.get("n_virtual", 1))
        grad_fn, _ = train.make_loss_and_grads(cfg32, mesh, SMOKE_M,
                                               device=dev, **kw)
        (loss, grads), stats = timed(lambda: grad_fn(params, tokens,
                                                     targets))
        extra = {}
        if label == "f32_quant":
            errs = []
            for g, e in zip(train.param_leaves(grads),
                            train.param_leaves(exact)):
                scale = e.abs().max().item() + 1e-6
                d = (g - e).abs()
                errs.append((d.max().item() / scale,
                             d.mean().item() / scale))
            extra = dict(quant_max=max(a for a, _ in errs),
                         quant_mean=max(b for _, b in errs))
        else:
            save_canonical(out_dir / f"{label}.rank{rank}.pt", grads, specs,
                           mesh)
        if label == "f32":
            exact = grads
        record(label, loss=loss.item(), **stats, **extra)
        del params, grads
    del exact
    torch.cuda.empty_cache()

    params, _ = params_for(1)
    opt = torch.optim.AdamW(train.param_leaves(params), lr=SMOKE_LR,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step, _ = train.make_train_step_optim(cfg16, mesh, SMOKE_M, opt,
                                          device=dev)
    losses, times, b10, wire, peak = [], [], [], None, 0
    for _ in range(SMOKE_STEPS):
        (loss, params), stats = timed(lambda: step(params, tokens, targets))
        losses.append(loss.item())
        times.append(stats["ms"])
        b10.append(stats["b10"])
        wire, peak = stats["wire"], max(peak, stats["peak"])
    record("bf16_adamw", losses=losses, ms=times, b10=b10, peak=peak,
           wire=wire)
    return dict(records=records)

# -- tensor-parallel inference -----------------------------------------------

# family -> (its module's tiny-config maker, the sizes): the JAX package's
# tests/test_tp_inference.py configurations, f32.
TP_SIZES = {
    "gpt2": ("tiny_config", dict(vocab=128, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_seq=64)),
    "llama": ("tiny_llama", dict(vocab=128, d_model=32, n_heads=8,
                                 n_kv_heads=4, n_layers=2, d_ff=64,
                                 max_seq=64)),
    "moe": ("tiny_moe_config", dict(vocab=128, d_model=32, n_heads=4,
                                    n_layers=2, d_ff=64, n_experts=8,
                                    top_k=2, capacity_factor=8.0,
                                    max_seq=64)),
}
TP_NEW = 10
TP_SAMPLE = dict(temperature=0.8, top_k=20, top_p=0.9)
MOE_MODES = ("replicated", "sharded", "auto")


def tp_model(family, seed=0, **kw):
    """The tiny f32 configuration of ``family`` (sizes overridden by
    ``kw``) and its parameters from ``seed`` on the CPU."""
    make, sizes = TP_SIZES[family]
    mod = family_module(family)
    cfg = dataclasses.replace(getattr(mod, make)(**{**sizes, **kw}),
                              dtype=torch.float32)
    return cfg, mod.init_params(cfg, seed=seed, device="cpu")


def tp_prompt(batch, vocab=128, seed=1, length=8):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int64))


def tp_mesh(n, tp):
    return mesh_from_devices({"dp": n // tp, "tp": tp})


def refusal(fn):
    """The message of the ValueError or AssertionError ``fn`` raises
    (None if it returns)."""
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def int8_weights(family, params):
    from mpi_acx_torch.ops import wquant
    names = wquant.LLAMA_WEIGHTS if family == "llama" else \
        wquant.GPT2_WEIGHTS
    return wquant.quantize_weights_int8(params, names)


def case_tp(rank, n, args):
    """Tensor-parallel generation at tp = 2 and 4 (meshes {"dp": n / tp,
    "tp": tp} of the same ranks): greedy tokens of the three families,
    MoE under each dispatch mode (batch 8; the auto fallback and the
    sharded refusal at batch 2, tp 4), int8 weights, each rank's slice of
    the laid-out weights, the same tokens from a sliced tree, sampled runs
    (twice with one key, once with another; every drawn token audited
    against its step's filter) and the refusals."""
    from mpi_acx_torch.models.decoding import filter_logits
    from mpi_acx_torch.parallel import tp_inference as tpi
    if args.full_width:
        import torch_tp_smoke
        return torch_tp_smoke.run(rank, n, args)
    out = {}
    builders = {"gpt2": tpi.make_tp_generate,
                "llama": tpi.make_tp_generate_llama,
                "moe": tpi.make_tp_generate_moe}
    rank_params = {
        "gpt2": lambda c, m, p: tpi._gpt2_rank_params(
            c, m, "tp", tpi.tp_param_specs(), tpi.tp_shard_params,
            tpi._gpt2_scale_specs("tp"), "test", torch.device("cpu"))(p),
        "llama": lambda c, m, p: tpi._llama_rank_params(
            c, m, "tp", torch.device("cpu"))(p)}
    for tp in (2, 4):
        mesh = tp_mesh(n, tp)
        for fam in ("gpt2", "llama"):
            cfg, params = tp_model(fam)
            gen = builders[fam](cfg, mesh, TP_NEW, device="cpu")
            out[("greedy", fam, tp)] = gen(params, tp_prompt(2))
            for q in (False, True):
                p = int8_weights(fam, params) if q else params
                out[("slice", fam, tp, q)] = rank_params[fam](cfg, mesh, p)
            out[("from_slice", fam, tp)] = gen(out[("slice", fam, tp, False)],
                                               tp_prompt(2))
        cfg, params = tp_model("moe")
        for mode in MOE_MODES:
            gen = tpi.make_tp_generate_moe(cfg, mesh, TP_NEW,
                                           ep_dispatch=mode, device="cpu")
            out[("moe", mode, tp)] = gen(params, tp_prompt(8))
        if tp == 4:
            gen = tpi.make_tp_generate_moe(cfg, mesh, TP_NEW, device="cpu")
            out[("moe", "auto_fallback", 4)] = gen(params, tp_prompt(2))
            gen = tpi.make_tp_generate_moe(cfg, mesh, 4,
                                           ep_dispatch="sharded",
                                           device="cpu")
            out[("refusal", "sharded_indivisible")] = refusal(
                lambda: gen(params, tp_prompt(2)))
    mesh = tp_mesh(n, 2)
    for fam in ("gpt2", "llama"):
        cfg, params = tp_model(fam)
        gen = builders[fam](cfg, mesh, TP_NEW, device="cpu")
        out[("int8", fam)] = gen(int8_weights(fam, params), tp_prompt(2))
    # Sampled runs, every drawn token checked against its filter set.
    sample = tpi.sample_logits
    audit = []

    def audited(logits, gen, temperature, top_k, top_p):
        tok = sample(logits, gen, temperature, top_k, top_p)
        f = filter_logits(logits, temperature, top_k, top_p)
        audit.append(bool((f.gather(-1, tok[:, None]) >
                           torch.finfo(f.dtype).min).all()))
        return tok

    tpi.sample_logits = audited
    try:
        for fam in ("gpt2", "llama"):
            cfg, params = tp_model(fam)
            gen = builders[fam](cfg, mesh, 16, device="cpu", **TP_SAMPLE)
            out[("sampled", fam)] = [gen(params, tp_prompt(2), key)
                                     for key in (3, 3, 4)]
    finally:
        tpi.sample_logits = sample
    out["audit"] = audit
    # The refusals of the JAX package's tests, at tp = 4.
    mesh = tp_mesh(n, 4)
    moe_cfg, moe_params = tp_model("moe")
    quant_moe = dict(moe_params, layers=dict(
        moe_params["layers"], w1_scale=torch.ones(2, 8, 1, 64)))
    out["refusals"] = {
        "heads": refusal(lambda: tpi.make_tp_generate(
            tp_model("gpt2", n_heads=2)[0], mesh, 4, device="cpu")),
        "kv_groups": refusal(lambda: tpi.make_tp_generate_llama(
            tp_model("llama", n_heads=4, n_kv_heads=2)[0], mesh, 4,
            device="cpu")),
        "experts": refusal(lambda: tpi.make_tp_generate_moe(
            tp_model("moe", n_experts=6)[0], mesh, 4, device="cpu")),
        "quantized_experts": refusal(lambda: tpi.make_tp_generate_moe(
            moe_cfg, mesh, 4, device="cpu")(quant_moe, tp_prompt(2))),
        "moe_int8_kv": refusal(lambda: tpi.make_tp_server_fns(
            moe_params, moe_cfg, mesh, family="moe", kv_int8=True,
            device="cpu")),
    }
    return out


TP_SERVE_SLOTS, TP_SERVE_MAX_LEN = 2, 32


def tp_serve_requests(vocab=128):
    """Five prompts of 3 to 8 tokens (one JAX prefill bucket) asking for
    3 to 7 new tokens."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, 3 + i).astype(np.int32)
               for i in (0, 5, 2, 4, 1)]
    return prompts, [3 + (i % 5) for i in range(5)]


TP_SERVES = [(fam, chunk, int8) for fam in ("gpt2", "llama", "moe")
             for chunk in (1, 4) for int8 in (False, True)
             if not (fam == "moe" and int8)]


def case_tp_serve(rank, n, args):
    """make_tp_server_fns under the port's serve_greedy at tp = n, for
    TP_SERVES (family, chunk, int8 KV)."""
    from mpi_acx_torch.models import serving
    from mpi_acx_torch.parallel import tp_inference as tpi
    mesh = mesh_from_devices({"tp": n})
    prompts, n_new = tp_serve_requests()
    out = {}
    for fam, chunk, int8 in TP_SERVES:
        cfg, params = tp_model(fam)
        fns = tpi.make_tp_server_fns(params, cfg, mesh, chunk=chunk,
                                     family=fam, kv_int8=int8, device="cpu")
        res = serving.serve_greedy(
            params, cfg, prompts, n_new, TP_SERVE_SLOTS, TP_SERVE_MAX_LEN,
            family=family_module(fam), chunk=chunk, server_fns=fns,
            kv_int8=int8, device="cpu")
        out[(fam, chunk, int8)] = [np.asarray(o) for o in res]
    return out


TP_SPEC_NEW, TP_SPEC_K = 14, 4


def case_tp_spec(rank, n, args):
    """Greedy make_tp_speculative_generate at tp = n: a GPT-2 target with
    a 1-layer GPT-2 draft (seed 7) and a Llama target with a 1-layer
    Llama draft, B = 1 and B = 2 rows; tokens and stats."""
    from mpi_acx_torch.parallel import tp_inference as tpi
    mesh = mesh_from_devices({"tp": n})
    out = {}
    for fam in ("gpt2", "llama"):
        cfg, params = tp_model(fam)
        dcfg, dparams = tp_model(fam, seed=7, n_layers=1)
        gen = tpi.make_tp_speculative_generate(dcfg, cfg, mesh, TP_SPEC_NEW,
                                               k=TP_SPEC_K, device="cpu")
        for b in (1, 2):
            toks, st = gen(dparams, params, tp_prompt(b))
            out[(fam, b)] = dict(tokens=toks, rounds=st["rounds"],
                                 accepted=st["drafted_accepted"])
    return out


# -- expert parallelism --------------------------------------------------------

EP_MESHES = {2: {"b": 2, "ep": 2}, 4: {"ep": 4}}
EP_CASES = [(ep, k, cf) for ep in (2, 4) for k in (1, 2)
            for cf in (2.0, 8.0)]
EP_T, EP_LR = 32, 0.1


def ep_layer(k, cf):
    from mpi_acx_torch.models import moe
    cfg = moe.MoeConfig(d_model=16, d_ff=32, n_experts=8,
                        capacity_factor=cf, top_k=k)
    return cfg, moe.init_moe_params(cfg, seed=3, device="cpu")


def ep_tokens(seed, d=16):
    return rng_array(seed, (EP_T, d))


def ep_block(tree, mesh, specs):
    from mpi_acx_torch import train
    return train.shard_params(tree, specs, mesh)


def case_ep(rank, n, args):
    """The all_to_all MoE entries at ep = 2 and 4, top-1 and top-2,
    capacity factors 2.0 (tokens drop per group) and 8.0: ``moe_layer``
    and ``moe_layer_and_aux`` on this rank's token shard,
    ``moe_layer_sharded_dispatch`` on tokens every rank holds, one
    ``make_moe_train_step`` step (the new shard), and one
    ``make_moe_transformer_train_step`` step of the tiny MoE model."""
    from mpi_acx_torch.models import moe, moe_transformer as mtf
    from mpi_acx_torch.parallel.mesh import PartitionSpec as P
    if args.full_width:
        import torch_tp_smoke
        return torch_tp_smoke.run_ep(rank, n, args)
    out = {"specs": mtf.param_specs("dp")}
    lspecs = {"gate": P(), "w1": P("ep"), "w2": P("ep")}
    for ep, k, cf in EP_CASES:
        mesh = mesh_from_devices(EP_MESHES[ep])
        cfg, params = ep_layer(k, cf)
        local = ep_block(params, mesh, lspecs)
        r, T = mesh.coords["ep"], EP_T // ep
        x = torch.from_numpy(ep_tokens(11))
        xs = x[r * T:(r + 1) * T]
        tgt = torch.from_numpy(ep_tokens(12))[r * T:(r + 1) * T]
        with mesh:
            y, aux = moe.moe_layer_and_aux(local, xs, cfg, ep_axis="ep")
            y2 = moe.moe_layer(local, xs, cfg, ep_axis="ep")
            ys = moe.moe_layer_sharded_dispatch(local, x, cfg, "ep")
        step = moe.make_moe_train_step(cfg, mesh, "ep", lr=EP_LR,
                                       device="cpu")
        old = {key: v.clone() for key, v in local.items()}
        loss, new = step(local, xs, tgt)
        out[("layer", ep, k, cf)] = dict(
            y=y, y2=y2, aux=aux, sharded=ys, loss=loss.item(),
            grads={key: (old[key] - new[key]) / EP_LR for key in old})
    for ep in (2, 4):
        mesh = mesh_from_devices(EP_MESHES[ep])
        cfg, params = ep_model()
        local = ep_block(params, mesh, mtf.param_specs("ep"))
        old = ep_block(params, mesh, mtf.param_specs("ep"))
        tokens, targets = ep_batch(cfg)
        r, b = mesh.coords["ep"], EP_BATCH // ep
        step = mtf.make_moe_transformer_train_step(cfg, mesh, axis="ep",
                                                   lr=EP_LR, device="cpu")
        loss, new = step(local, tokens[r * b:(r + 1) * b],
                         targets[r * b:(r + 1) * b])
        grads = {key: (old[key] - new[key]) / EP_LR
                 for key in old if key != "layers"}
        grads["layers"] = {key: (old["layers"][key] - new["layers"][key])
                           / EP_LR for key in old["layers"]}
        out[("model", ep)] = dict(loss=loss.item(), grads=grads)
    return out


EP_BATCH = 4


def ep_model():
    """The tiny MoE transformer of the EP train step (top-2, capacity
    factor 2.0: tokens drop per rank group)."""
    return tp_model("moe", top_k=2, capacity_factor=2.0, max_seq=16)


def ep_batch(cfg, S=8):
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (EP_BATCH, S)).astype(np.int64))
    return tokens, torch.roll(tokens, -1, dims=-1)


# -- Ulysses and the partitioned exchange --------------------------------------

ULYSSES_MESHES = {2: {"b": 2, "x": 2}, 4: {"x": 4}}
ULYSSES_SHAPE = (64, 8, 16)           # global [S, H, D]


def ulysses_qkv(ring):
    return [rng_array(700 + 10 * ring + j, ULYSSES_SHAPE) for j in range(3)]


def case_ulysses(rank, n, args):
    """ulysses_attention_sharded at 2 and 4 ranks, causal and not, on this
    rank's sequence block; the refusal of heads not divisible by the
    axis."""
    from mpi_acx_torch.parallel import ulysses
    if args.full_width:
        import torch_tp_smoke
        return torch_tp_smoke.run_ulysses(rank, n, args)
    out = {}
    for ring, shape in ULYSSES_MESHES.items():
        mesh = mesh_from_devices(shape)
        r, sq = mesh.coords["x"], ULYSSES_SHAPE[0] // ring
        qkv = [torch.from_numpy(t[r * sq:(r + 1) * sq])
               for t in ulysses_qkv(ring)]
        for causal in (True, False):
            out[(ring, causal)] = ulysses.ulysses_attention_sharded(
                *qkv, mesh, "x", causal=causal)
    mesh = mesh_from_devices(ULYSSES_MESHES[4])
    x = torch.zeros(4, 2, 16)
    out["refusal"] = refusal(
        lambda: ulysses.ulysses_attention_sharded(x, x, x, mesh, "x"))
    return out


def case_partitioned(rank, n, args):
    """tests/test_partitioned.py's three cases on an n-ring: the
    exchange's identity, with a consumer, and the pipeline."""
    from mpi_acx_torch.parallel import partitioned as pt
    if args.full_width:
        import torch_tp_smoke
        return torch_tp_smoke.run_partitioned(rank, n, args)
    mesh = make_mesh()
    x = torch.arange(12 * n, dtype=torch.float32).reshape(12 * n, 1)
    ones = torch.ones(4 * n, 2)
    with mesh:
        ident = pt.partitioned_ring_exchange(x[rank * 12:(rank + 1) * 12],
                                             "x", partitions=4)
        cons = pt.partitioned_ring_exchange(
            ones[rank * 4:(rank + 1) * 4], "x", partitions=2,
            consume=lambda c: c * 3.0)
        acc = pt.partitioned_pipeline(
            lambda k: torch.full((3,), rank * 100.0 + k),
            lambda a, p: a + p, torch.zeros(3), 5, "x")
    return dict(identity=ident, consumer=cons, pipeline=acc)


CASES = {"collectives": case_collectives, "mesh": case_mesh,
         "ring": case_ring, "quantized": case_quantized,
         "train": case_train, "multihost": case_multihost,
         "smoke": case_smoke, "tp": case_tp, "tp_serve": case_tp_serve,
         "tp_spec": case_tp_spec, "ep": case_ep, "ulysses": case_ulysses,
         "partitioned": case_partitioned}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--family", default="gpt2")
    ap.add_argument("--layers", type=int, default=None,
                    help="smoke: GPT-2 124M cut to this many layers")
    ap.add_argument("--full-width", action="store_true",
                    help="the full-width form of a case (chip_smoke.py's "
                    "phase 7d; tests/torch_tp_smoke.py)")
    ap.add_argument("--dump-after", type=float, default=0,
                    help="print every thread's stack and exit after this "
                    "many seconds (a hang's evidence)")
    args = ap.parse_args()
    if args.dump_after:
        faulthandler.dump_traceback_later(args.dump_after, exit=True)
    torch.set_num_threads(1)
    multihost.initialize(backend=args.backend)
    rank, n = multihost.process_index(), multihost.process_count()
    res = CASES[args.case](rank, n, args)
    torch.save(res, Path(args.out) / f"{args.case}.rank{rank}.pt")
    multihost.sync()
    multihost.shutdown()
    print(f"RANK_OK {args.case} rank={rank}", flush=True)


if __name__ == "__main__":
    main()
