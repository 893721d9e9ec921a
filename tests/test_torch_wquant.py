"""The port's int8 weight-only quantization (``mpi_acx_torch/ops/wquant.py``)
held against the JAX package's (``mpi_acx_tpu/ops/wquant.py``).

The trees are drawn by the port on the CPU (seeded), in f32 and bf16, and
handed to JAX as numpy arrays. The JAX package quantizes eagerly (no
jit), so its scale and codes are true divisions, ``amax / 127`` and ``w /
s``; the port divides too, and its codes and scales must equal JAX's bit
for bit. Then: the port's layer-by-layer form equals the whole-leaf form,
``weight_bytes`` agrees, the dequantized read lies within ``amax / 254``,
and int8-weight ``forward``/``generate`` equal the JAX package's on
``tiny_config`` and ``tiny_llama`` in f32 (logits within 1e-5, tokens
equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_tpu.ops import wquant as jw
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import moe_transformer as tm
from mpi_acx_torch.models import transformer as tt
from mpi_acx_torch.ops import wquant as tw

TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if tree.dtype == torch.bfloat16 \
        else tree.numpy()


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype)
                        if a.dtype == np.float32 else jnp.asarray(a),
                        _numpy(tree))


GPT2 = dict(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=32)
LLAMA = dict(vocab=61, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, max_seq=32)


def _families():
    """(torch module, JAX module, torch config, JAX config, weight names)
    per family, f32 compute."""
    return {
        "gpt2": (tt, jt,
                 dataclasses.replace(tt.tiny_config(**GPT2),
                                     dtype=torch.float32),
                 dataclasses.replace(jt.tiny_config(**GPT2),
                                     dtype=jnp.float32), tw.GPT2_WEIGHTS),
        "llama": (tl, jl,
                  dataclasses.replace(tl.tiny_llama(**LLAMA),
                                      dtype=torch.float32),
                  dataclasses.replace(jl.tiny_llama(**LLAMA),
                                      dtype=jnp.float32), tw.LLAMA_WEIGHTS)}


def test_weight_name_lists_match_jax():
    assert tw.GPT2_WEIGHTS == jw.GPT2_WEIGHTS
    assert tw.LLAMA_WEIGHTS == jw.LLAMA_WEIGHTS


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_codes_and_scales_bit_equal_to_jax(family, dtype):
    tmod, _, cfg, _, names = _families()[family]
    params = tmod.init_params(cfg, seed=3, device="cpu")
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    params = tt.cast_params(params, tdt)
    got = tw.quantize_weights_int8(params, names)
    want = jw.quantize_weights_int8(_to_jax(params, jdt), names)
    assert set(got["layers"]) == set(want["layers"])
    for name in names:
        for leaf in (name, name + "_scale"):
            g, w = got["layers"][leaf], np.asarray(want["layers"][leaf])
            assert g.dtype == (torch.int8 if leaf == name
                               else torch.float32), leaf
            assert tuple(g.shape) == w.shape, leaf
            np.testing.assert_array_equal(g.numpy(), w, err_msg=leaf)
    # Everything else is the caller's tensor, untouched.
    assert got["embed"] is params["embed"]
    assert params["layers"][names[0]].dtype == tdt
    assert tw.weight_bytes(got) == jw.weight_bytes(want)
    assert tw.weight_bytes(params) == jw.weight_bytes(_to_jax(params, jdt))


def test_layer_sliced_form_equals_whole_leaf():
    """quantize_weights_int8 quantizes one layer slice at a time; the
    whole-leaf _quant_leaf gives the same bits."""
    g = torch.Generator().manual_seed(5)
    w = torch.randn(4, 48, 24, generator=g) * torch.rand(1, 1, 24,
                                                          generator=g)
    w[2, :, 7] = 0.0                       # an all-zero channel: the floor
    q = tw.quantize_weights_int8({"layers": {"w": w}}, ["w"])["layers"]
    q_all, s_all = tw._quant_leaf(w)
    assert torch.equal(q["w"], q_all) and torch.equal(q["w_scale"], s_all)
    assert q["w_scale"].shape == (4, 1, 24)
    assert (q["w_scale"][2, 0, 7] == torch.tensor(1e-12) / 127.0).item()


def test_wread_within_half_a_step():
    """The dequantized read lies within scale / 2 = amax / 254 of each
    weight, as the JAX package's own test bounds it."""
    w = torch.randn(4, 64, 32, generator=torch.Generator().manual_seed(0))
    w = w * 0.3
    q = tw.quantize_weights_int8({"layers": {"w": w}}, ["w"])["layers"]
    back = tw.wread(q, "w", torch.float32)
    amax = w.abs().amax(dim=-2, keepdim=True)
    assert ((back - w).abs() / (amax / 127.0)).max().item() <= 0.5 + 1e-3
    assert torch.equal(tw.wread({"w": w}, "w", torch.bfloat16),
                       w.to(torch.bfloat16))


def test_weight_bytes_roughly_halve():
    _, _, cfg, _, names = _families()["gpt2"]
    cfg = dataclasses.replace(cfg, d_model=64, n_heads=4, n_layers=4,
                              d_ff=256)
    params = tt.cast_params(tt.init_params(cfg, seed=0, device="cpu"),
                            torch.bfloat16)
    q = tw.quantize_weights_int8(params, names)
    assert tw.weight_bytes(q) < 0.6 * tw.weight_bytes(params)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_int8_weight_forward_and_generate_match_jax(family):
    tmod, jmod, cfg, jcfg, names = _families()[family]
    params = tmod.init_params(cfg, seed=1, device="cpu")
    qt = tw.quantize_weights_int8(params, names)
    qj = jw.quantize_weights_int8(_to_jax(params, jnp.float32), names)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    np.testing.assert_allclose(
        tmod.forward(qt, cfg, torch.from_numpy(tok)).numpy(),
        np.asarray(jmod.forward(qj, jcfg, jnp.asarray(tok))), **TOL)
    prompt = tok[:, :6]
    got = tmod.generate(qt, cfg, torch.from_numpy(prompt), 8, max_len=16,
                        device="cpu")
    want = jmod.generate(qj, jcfg, jnp.asarray(prompt), 8, max_len=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_moe_experts_are_refused():
    """The expert products have no wread path: int8 experts are refused,
    int8 attention weights serve."""
    cfg = dataclasses.replace(
        tm.tiny_moe_config(vocab=31, d_model=16, n_heads=2, n_layers=1,
                           d_ff=16, n_experts=4, capacity_factor=4.0,
                           max_seq=16), dtype=torch.float32)
    params = tm.init_params(cfg, seed=0, device="cpu")
    prompt = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="int8 weight-only"):
        tm.generate(tw.quantize_weights_int8(params, ("w1",)), cfg, prompt,
                    2, device="cpu")
    out = tm.generate(tw.quantize_weights_int8(params, ("wqkv", "wo")), cfg,
                      prompt, 2, device="cpu")
    assert out.shape == (1, 6)
