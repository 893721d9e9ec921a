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
    """Phase 7c: GPT-2 124M at full width and depth on the 2x2x2 mesh, one
    card shared by all ranks. (a) f32 step 0 under GPipe, (b) the same
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


CASES = {"collectives": case_collectives, "mesh": case_mesh,
         "ring": case_ring, "quantized": case_quantized,
         "train": case_train, "multihost": case_multihost,
         "smoke": case_smoke}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--family", default="gpt2")
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
