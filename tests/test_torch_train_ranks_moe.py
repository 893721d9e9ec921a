"""The MoE family's cases of tests/test_torch_train_ranks.py (8 experts,
top-2, capacity factor 1.0 so that tokens drop; experts split over tp
with replicated tokens and one psum; the router losses gated to tp rank
0 and seeded in every 1F1B backward): the port's
train step on eight gloo ranks at dp x pp x tp = 2 x 2 x 2 under GPipe,
``n_virtual=2``, 1F1B, remat and ``dp_quant_bits=8``, loss and every
assembled gradient leaf held to the JAX package's
``make_loss_and_grads`` on the 8-device CPU mesh (loss rtol 1e-5; leaves
atol 1e-5, rtol 1e-4). A file of its own so that each stays under 30 s
on the CPU.
"""

import pytest

from tests import torch_rank_worker as worker
from tests.test_torch_train_ranks import (check_family, jax_reference,
                                          launch_family)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_family(tmp_path_factory, "moe")


@pytest.fixture(scope="module")
def want():
    return jax_reference("moe")


@pytest.mark.parametrize("option", sorted(worker.TRAIN_OPTIONS))
def test_moe_step_across_ranks_matches_jax(ranks, want, option):
    check_family(ranks, "moe", option, want(option))
