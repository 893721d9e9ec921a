"""Operations and bytes against counts worked by hand at GPT-2's and
Mistral-7B-v0.3's shapes."""

import json

import pytest
from conftest import BENCH

from acxbench import flops
from acxbench.roofline import bound_ms, decode_bytes

GPT2 = flops.dims(json.loads((BENCH / "configs/gpt2-124m.json").read_text()))
MIS = flops.dims(json.loads((BENCH / "configs/mistral-7b-v0.3.json")
                            .read_text()))


def test_dims():
    assert (GPT2.layers, GPT2.d, GPT2.heads, GPT2.kv_heads, GPT2.head_dim,
            GPT2.ff, GPT2.vocab) == (12, 768, 12, 12, 64, 3072, 50257)
    assert (MIS.layers, MIS.d, MIS.heads, MIS.kv_heads, MIS.head_dim,
            MIS.ff, MIS.vocab) == (32, 4096, 32, 8, 128, 14336, 32768)
    # 4 * 768^2 + 2 * 768 * 3072; 4096^2 * 2 + 2 * 4096 * 1024 + 3 * 4096
    # * 14336.
    assert GPT2.layer_matmul_params == 7077888
    assert MIS.layer_matmul_params == 218103808
    # Mistral-7B-v0.3: 7.248 B with both vocab matrices and the norms.
    total = (32 * MIS.layer_matmul_params + 2 * MIS.head_params
             + 65 * 4096)
    assert total == 7248023552


def test_serving_flops():
    # 12 * (2 * 7077888 * 100 + 4 * 64 * 12 * 5050) + 2 * 768 * 50257
    assert flops.prefill_flops(GPT2, 100) == 17250289152
    # 12 * (2 * 7077888 + 4 * 64 * 12 * 100) + 2 * 768 * 50257
    assert flops.decode_flops(GPT2, 99) == 250750464
    assert flops.request_flops(GPT2, 100, 3) == (
        17250289152 + flops.decode_flops(GPT2, 100)
        + flops.decode_flops(GPT2, 101))
    assert flops.request_flops(GPT2, 100, 1) == 17250289152
    # 32 * (2 * 218103808 + 4 * 128 * 32 * 4097) + 2 * 4096 * 32768
    assert flops.decode_flops(MIS, 4096) == 16375087104


def test_train_flops():
    # per sequence 12 * (2 * 7077888 * 1024 + 4 * 64 * 12 * 524800)
    # + 2 * 38597376 * 1024; times 32 sequences, times 3
    assert flops.train_step_flops(GPT2, 32, 1024) == 26144623558656


def test_kernel_costs():
    assert flops.k1_cost(1, 100, 12, 64) == (15513600, 614400)
    assert flops.k1_cost(8, 1024, 12, 64, lse=True) == (12897484800,
                                                       50724864)
    assert flops.k2_cost(1000, 8, 32, 8, 128) == (16384000, 4227104)
    assert decode_bytes(1000, 8, False, False, hkv=8, hq=32,
                        head_dim=128) == 4227104


@pytest.mark.parametrize("fl,nb,by", [(989e12, 0, "operations"),
                                      (0, 3.35e12, "bytes")])
def test_bound(fl, nb, by):
    ms, which = bound_ms(fl, nb)
    assert ms == pytest.approx(1000.0) and which == by
