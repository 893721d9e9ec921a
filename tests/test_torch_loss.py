"""The port's transformer.loss_fn and stage_slice held against the JAX
package's, and the train step with the chunked-vocab CE.

loss_fn: value and gradients against ``jax.value_and_grad(tfm.loss_fn)``
in float32, naive and chunked CE: value rtol 1e-6, gradients atol 1e-5
and rtol 1e-4 (summation order); the step as tests/test_torch_train.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_torch.models import transformer as ttfm
from tests.test_torch_train import (M, MB, S, SIZES, _assert_params_close,
                                    _configs, _data, run_sgd_case)


def test_sgd_steps_with_chunked_xent_match_jax():
    """The chunked-vocab CE (a chunk of 16 that does not divide the 61-row
    vocabulary) through three SGD steps (dense ring blocks: the CE does
    not depend on the attention branch, and they compile faster in
    JAX)."""
    run_sgd_case(False, 16)


@pytest.mark.parametrize("xent_chunk", [None, 7])
def test_loss_fn_value_and_grads_match_jax(xent_chunk):
    """transformer.loss_fn against jax.value_and_grad(tfm.loss_fn), f32,
    naive and chunked CE; the weights cross as requires-grad leaves."""
    jcfg, tcfg = _configs(True)
    params = jtfm.init_params(jax.random.key(4), jcfg)
    tokens, targets = (x.reshape(M * MB, S) for x in _data(4))
    jl, jg = jax.jit(jax.value_and_grad(jtfm.loss_fn), static_argnums=(1, 4))(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(targets), xent_chunk)
    tp = ttfm.params_from_jax(jax.device_get(params), device="cpu",
                              requires_grad=True)
    tl = ttfm.loss_fn(tp, tcfg, torch.from_numpy(tokens).long(),
                      torch.from_numpy(targets), xent_chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    grads = {k: ({n: a.grad for n, a in v.items()} if isinstance(v, dict)
                 else v.grad) for k, v in tp.items()}
    _assert_params_close(grads, jg)


def test_stage_slice_matches_jax_and_shares_storage():
    jcfg, _ = _configs(True)
    cfg4 = dataclasses.replace(jcfg, n_layers=4)
    params = jtfm.init_params(jax.random.key(5), cfg4)
    tp = ttfm.params_from_jax(jax.device_get(params), device="cpu",
                              requires_grad=True)
    staged = ttfm.stage_slice(tp, 2)
    want = jax.device_get(jtfm.stage_slice(params, 2))
    for key, a in staged["layers"].items():
        assert a.shape == want["layers"][key].shape and a.is_leaf
        assert a.requires_grad
        np.testing.assert_array_equal(a.detach().numpy(), want["layers"][key])
    with torch.no_grad():
        staged["layers"]["b2"][1, 0] += 1.0
    assert tp["layers"]["b2"][2].sum().item() == SIZES["d_model"]
    with pytest.raises(ValueError, match="do not split"):
        ttfm.stage_slice(tp, 3)
