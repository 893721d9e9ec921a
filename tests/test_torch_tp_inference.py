"""Tensor-parallel generation across ranks
(mpi_acx_torch/parallel/tp_inference.py): four gloo ranks, on meshes
{"dp": 2, "tp": 2} and {"tp": 4} of the same ranks, held against the JAX
package's TP builders on the 8-device CPU mesh, f32, on
tests/test_tp_inference.py's tiny configurations.

Greedy tokens of GPT-2, Llama (split by KV group) and the MoE transformer
(each dispatch mode at batch 8; auto's fallback to replicated at batch 2
and tp 4) equal JAX's exactly, on every rank; so do an int8-weight
checkpoint's and a tree already sliced. Each rank's slice of the laid-out
weights, with and without int8 scale companions, equals JAX's
``tp_shard_params*`` output cut by JAX's specs. Sampled runs are equal
across ranks and calls with one key, differ with another, and every drawn
token lies in its step's filter set (the port's own properties: the two
packages' random streams differ). The refusals are JAX's: heads, KV
groups or experts not divisible, sharded dispatch at an indivisible token
count, quantized experts, int8 KV in MoE serving.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import moe_transformer as jmt
from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel import tp_inference as jtp
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker

N = 4
JAX_MODULES = {"gpt2": jtfm, "llama": jl, "moe": jmt}
JAX_BUILDERS = {"gpt2": jtp.make_tp_generate,
                "llama": jtp.make_tp_generate_llama,
                "moe": jtp.make_tp_generate_moe}
JAX_LAYOUT = {"gpt2": (jtp.tp_shard_params, jtp.tp_param_specs,
                       jtp._gpt2_scale_specs),
              "llama": (jtp.tp_shard_params_llama, jtp.tp_param_specs_llama,
                        jtp._llama_scale_specs)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The job, started: a future of the ranks' results (each test reads
    it after its JAX side has run)."""
    return worker.start("tp", N, tmp_path_factory.mktemp("tp"))


def np_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@functools.lru_cache(maxsize=None)
def jax_model(family, int8=False):
    """The worker's configuration and parameters on the JAX side."""
    cfg, params = worker.tp_model(family)
    if int8:
        params = worker.int8_weights(family, params)
    make, sizes = worker.TP_SIZES[family]
    jcfg = getattr(JAX_MODULES[family], make)(**sizes)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.float32})
    return jcfg, np_tree(params)


@functools.lru_cache(maxsize=None)
def jax_tokens(family, tp, batch=2, int8=False, **kw):
    jcfg, params = jax_model(family, int8)
    gen = JAX_BUILDERS[family](jcfg, jmesh({"tp": tp}, jax.devices()[:tp]),
                               worker.TP_NEW, **kw)
    prompt = jnp.asarray(worker.tp_prompt(batch).numpy().astype(np.int32))
    return np.asarray(gen(params, prompt, jax.random.key(2)))


def same_on_every_rank(ranks, key, want):
    got = ranks.result()
    for r in range(N):
        np.testing.assert_array_equal(got[r][key].numpy(), want,
                                      err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_greedy_tokens_equal_jax(ranks, family, tp):
    same_on_every_rank(ranks, ("greedy", family, tp), jax_tokens(family, tp))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_a_sliced_tree_gives_the_same_tokens(ranks, family, tp):
    same_on_every_rank(ranks, ("from_slice", family, tp),
                       jax_tokens(family, tp))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", worker.MOE_MODES)
def test_moe_tokens_equal_jax_in_each_dispatch_mode(ranks, mode, tp):
    same_on_every_rank(ranks, ("moe", mode, tp),
                       jax_tokens("moe", tp, batch=8, ep_dispatch=mode))


def test_moe_auto_falls_back_at_an_indivisible_batch(ranks):
    same_on_every_rank(ranks, ("moe", "auto_fallback", 4),
                       jax_tokens("moe", 4, batch=2))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_int8_weight_checkpoint_equals_jax(ranks, family):
    same_on_every_rank(ranks, ("int8", family),
                       jax_tokens(family, 2, int8=True))


def jax_slice(family, tp, r, int8):
    """JAX's laid-out tree of the worker's parameters cut to the block of
    tp rank ``r`` by JAX's specs."""
    shard, specs, scale_specs = JAX_LAYOUT[family]
    jcfg, params = jax_model(family, int8)
    sspecs = jtp._specs_with_scales(specs("tp"), jtp._scale_keys(params),
                                    scale_specs("tp"), "test")
    laid = jax.tree.map(np.asarray, shard(params, jcfg))

    def cut(a, spec):
        for dim, axis in enumerate(spec):
            if axis == "tp":
                size = a.shape[dim] // tp
                a = np.take(a, np.arange(r * size, (r + 1) * size), axis=dim)
        return a

    return jax.tree.map(cut, laid, sspecs,
                        is_leaf=lambda x: isinstance(x, np.ndarray))


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_each_rank_slice_is_jax_layout(ranks, family, tp, int8):
    got = ranks.result()
    for r in range(N):
        want = jax_slice(family, tp, r % tp, int8)
        mine = np_tree(got[r][("slice", family, tp, int8)])
        assert jax.tree.structure(mine) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_sampled_runs_agree_across_ranks_and_calls(ranks, family):
    got = ranks.result()
    a, b, c = got[0][("sampled", family)]
    for r in range(N):
        for x, y in zip(got[r][("sampled", family)], (a, b, c)):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (a != c).any()
    prompt = worker.tp_prompt(2)
    np.testing.assert_array_equal(a[:, :prompt.shape[1]].numpy(),
                                  prompt.numpy())
    assert ((a >= 0) & (a < 128)).all()


def test_every_drawn_token_lies_in_its_filter_set(ranks):
    got = ranks.result()
    for r in range(N):
        # 2 families x 3 runs x 16 draws (the first and 15 decode steps).
        assert len(got[r]["audit"]) == 96 and all(got[r]["audit"])


def jax_refuses(fn, exc=AssertionError):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_refusals_are_jax_refusals(ranks):
    mesh4 = jmesh({"tp": 4}, jax.devices()[:4])
    sharded = jax_refuses(lambda: jax_tokens("moe", 4, batch=2,
                                             ep_dispatch="sharded"),
                          ValueError)
    got = ranks.result()
    for r in range(N):
        ref = got[r]["refusals"]
        assert ref["heads"] == "ValueError: n_heads 2 not divisible by tp=4"
        assert ref["kv_groups"] == ("ValueError: n_kv_heads 2 not divisible "
                                    "by tp=4")
        assert ref["experts"] == "ValueError: n_experts 6 not divisible by " \
            "tp=4"
        assert "int8 quantization of ['w1_scale']" in \
            ref["quantized_experts"]
        assert ref["moe_int8_kv"] == ("ValueError: int8 KV slot caches: "
                                      "gpt2/llama only for now")
        assert got[r][("refusal", "sharded_indivisible")] == \
            f"ValueError: {sharded}"
    jax_refuses(lambda: jtp.make_tp_generate(
        jtfm.tiny_config(n_heads=2), mesh4, 4))
    jax_refuses(lambda: jtp.make_tp_generate_llama(
        jl.tiny_llama(n_heads=4, n_kv_heads=2), mesh4, 4))
    assert "6" in jax_refuses(lambda: jtp.make_tp_generate_moe(
        jmt.tiny_moe_config(n_heads=4, n_experts=6), mesh4, 4))
    jcfg, params = jax_model("moe")
    quant = dict(params, layers=dict(params["layers"],
                                     w1_scale=np.ones((2, 8, 1, 64),
                                                      np.float32)))
    msg = jax_refuses(lambda: jtp.make_tp_generate_moe(jcfg, mesh4, 4)(
        quant, jnp.zeros((2, 8), jnp.int32), jax.random.key(0)), ValueError)
    assert "int8 quantization of ['w1_scale']" in msg
    assert jax_refuses(lambda: jtp.make_tp_server_fns(
        params, jcfg, mesh4, family="moe", kv_int8=True), ValueError) == \
        "int8 KV slot caches: gpt2/llama only for now"


def test_specs_are_jax_specs():
    from mpi_acx_torch.parallel import tp_inference as ttp
    for name in ("tp_param_specs", "tp_param_specs_llama",
                 "tp_param_specs_moe", "_gpt2_scale_specs",
                 "_moe_scale_specs", "_llama_scale_specs"):
        mine, want = getattr(ttp, name)("tp"), getattr(jtp, name)("tp")
        flat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, JP))
        assert [tuple(s) for s in jax.tree.leaves(
            mine, is_leaf=lambda x: isinstance(x, tuple))] == \
            [tuple(s) for s in flat], name
