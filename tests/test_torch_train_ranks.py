"""The port's train step across ranks: eight gloo ranks on a dp x pp x tp =
2 x 2 x 2 mesh, each holding its shard (``train.shard_params``,
``train.shard_batch``), held against the JAX package's
``make_loss_and_grads`` on the 8-device CPU mesh. GPT-2 here; the Llama
and MoE families in tests/test_torch_train_ranks_llama.py and
tests/test_torch_train_ranks_moe.py.

One job (tests/torch_rank_worker.py ``train``) runs the step under GPipe,
``n_virtual=2``, ``schedule="1f1b"``, ``remat=True`` and
``dp_quant_bits=8`` on the tiny f32 configuration (4 layers: 2 stages of
2 chunks; 2 microbatches of 2 x 16 tokens: one sequence a dp rank, an
8-token block a tp rank) through the ring's flash blocks (B10's plain
version and the blockwise backward, whose lse cotangent is nonzero at
tp = 2). The main process assembles every rank's gradient shards with
``train.unshard_params`` and holds the loss and every leaf to JAX's (its
dense ring blocks: the same function), the exact options to JAX's GPipe
step (the JAX package's own tests show its options equal to GPipe) and
the quantized sync to JAX's quantized step, at the port's tolerances:
loss rtol 1e-5, leaves atol 1e-5 and rtol 1e-4. The interleaved layout
[pp, v, L / (pp v), ...] is read back into layer order first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import moe_transformer as jmt
from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from tests import torch_rank_worker as worker

N = 8
JAX_MODULES = {"gpt2": jtfm, "llama": jl, "moe": jmt}


def launch_family(tmp_path_factory, family):
    """The family's job, started: a future of the ranks' results (the
    JAX side compiles meanwhile)."""
    return worker.start("train", N, tmp_path_factory.mktemp(family),
                        "--family", family)


def jax_config(family):
    """The worker's configuration on the JAX side (dense ring blocks)."""
    make, sizes = worker.TRAIN_SIZES[family]
    return dataclasses.replace(getattr(JAX_MODULES[family], make)(**sizes),
                               dtype=jnp.float32, use_flash=False)


def jax_loss_and_grads(family, **kw):
    """JAX's 2x2x2 step on the worker's parameters and batch: (loss,
    numpy grads in the stage-sliced layout)."""
    tcfg = worker.train_config(family)
    jcfg = jax_config(family)
    np_params = jax.tree.map(
        lambda t: t.numpy(), worker.train_init(family, tcfg))
    mesh = jmesh(worker.MESH3)
    params = jtfm.stage_slice(jax.tree.map(jnp.asarray, np_params), 2)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
        jtrain._family(jcfg).specs())
    fn, _ = jtrain.make_loss_and_grads(jcfg, mesh, worker.TRAIN_M,
                                       aux_weight=worker.AUX_W,
                                       z_weight=worker.Z_W, **kw)
    tokens, targets = (jnp.asarray(t.astype(np.int32))
                       for t in worker.train_batch())
    loss, grads = fn(params, tokens, targets)
    return float(loss), jax.device_get(grads)


def layer_order(tree, n_virtual):
    """Layer leaves as [L, ...]: [pp, L / pp, ...] in order, or the
    interleaved [pp, v, per, ...] (global stage j * pp + s at [s, j])."""
    def flat(a):
        a = np.asarray(a)
        if n_virtual > 1:
            a = np.swapaxes(a, 0, 1)
        return a.reshape((-1,) + a.shape[(3 if n_virtual > 1 else 2):])
    return {k: ({n: flat(x) for n, x in v.items()} if k == "layers"
                else np.asarray(v)) for k, v in tree.items()}


def check_family(job, family, option, want):
    """Every rank's loss and the assembled gradients (``job``'s results)
    against ``want`` (JAX's loss and grads)."""
    kw = worker.TRAIN_OPTIONS[option]
    v = kw.get("n_virtual", 1)
    want_loss, want_grads = want
    ranks = job.result()
    for r in range(N):
        np.testing.assert_allclose(ranks[r][option]["loss"], want_loss,
                                   rtol=1e-5, err_msg=f"rank {r}")
    specs = ttrain.step_specs(worker.train_config(family), v)
    got = ttrain.unshard_params({r: ranks[r][option]["grads"]
                                 for r in range(N)}, specs, worker.MESH3)
    got = layer_order(jax.tree.map(lambda t: t.numpy(), got), v)
    want_grads = layer_order(want_grads, 1)
    assert sorted(got) == sorted(want_grads)
    for k, w in want_grads.items():
        pairs = w.items() if k == "layers" else [(k, w)]
        for name, wv in pairs:
            g = got[k][name] if k == "layers" else got[k]
            np.testing.assert_allclose(g, wv, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{option} {name}")


def jax_reference(family):
    cache = {}

    def get(option):
        key = "quant" if option == "quant" else "exact"
        if key not in cache:
            cache[key] = jax_loss_and_grads(
                family, **({"dp_quant_bits": 8} if key == "quant" else {}))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_family(tmp_path_factory, "gpt2")


@pytest.fixture(scope="module")
def want():
    return jax_reference("gpt2")


@pytest.mark.parametrize("option", sorted(worker.TRAIN_OPTIONS))
def test_gpt2_step_across_ranks_matches_jax(ranks, want, option):
    check_family(ranks, "gpt2", option, want(option))


def test_dp_ranks_hold_equal_gradients(ranks):
    """The dp sync leaves both dp ranks of every (pp, tp) place with the
    same gradients: bit-equal, exact and quantized."""
    ranks = ranks.result()
    for option in ("gpipe", "quant"):
        for r in range(4):
            a = ttrain.param_leaves(ranks[r][option]["grads"])
            b = ttrain.param_leaves(ranks[r + 4][option]["grads"])
            assert all(np.array_equal(x.numpy(), y.numpy())
                       for x, y in zip(a, b))
