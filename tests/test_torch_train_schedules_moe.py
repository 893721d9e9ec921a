"""The MoE family's cases of tests/test_torch_train_schedules_llama.py
(its four options; the Llama file also runs 1F1B under remat): each
pipeline option of the port's train step (the router losses seeded in
every 1F1B backward, gated to tp rank 0) held against the JAX
package's GPipe ``make_train_step``, three SGD steps in float32 at
capacity factor 1.0 (tokens drop), flash and dense blocks (loss rtol
1e-5; params atol 1e-5, rtol 1e-4). A file of its own so that each stays
under 30 s on the CPU."""

import pytest

from tests.test_torch_train_schedules import OPTIONS
from tests.test_torch_train_schedules_llama import (  # noqa: F401
    jax_gpipe, run_family_case)


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "dense"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_moe_option_steps_match_jax_gpipe(jax_gpipe, option,  # noqa: F811
                                          use_flash):
    run_family_case(jax_gpipe, "moe", option, use_flash)
