"""The DeepSeek-V2 cell's pieces on the CPU at a tiny size: the plain
reference against the port in float32, a sound run that comes out correct
and one with a served token altered that does not, and the three readers
of its kernels on made-up traces (a program without the kernels or the
counters reads nothing)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import BENCH, DATA
from test_acxbench_faults import _token_altered

from acxbench import deepseek_cost, flops, harness
from acxbench.families import deepseek_v2 as fam
from acxbench.reference.common import exact_f32, matmul
from acxbench.trace import Trace

CELL = "tiny-deepseek-v2.serve"


def test_logits_match_port():
    cfg = json.loads((DATA / "tiny-deepseek-v2.json").read_text())
    params = fam.draw_params(cfg, 3, "cpu", torch.float32)
    pcfg = fam.port_config(cfg, torch.float32)
    tokens = torch.randint(0, pcfg.vocab, (40,),
                           generator=torch.Generator().manual_seed(1))
    want = fam.port_module().forward(params, pcfg, tokens[None])[0]
    with exact_f32():
        got = fam.reference.logits_at(params, cfg, tokens, torch.arange(40),
                                      matmul("f32"))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_lite_config_is_the_catalog_model():
    cfg = json.loads((BENCH / "configs" / "deepseek-v2-lite.json")
                     .read_text())
    pcfg = fam.port_config(cfg, torch.bfloat16)
    assert cfg["reduced"] == []
    assert (pcfg.n_layers, pcfg.d_model, pcfg.n_heads, pcfg.vocab) == (
        27, 2048, 16, 102400)
    assert (pcfg.n_experts, pcfg.n_shared, pcfg.top_k, pcfg.d_expert) == (
        64, 2, 6, 1408)
    assert (pcfg.kv_lora, pcfg.qk_nope, pcfg.qk_rope, pcfg.v_head) == (
        512, 128, 64, 128)
    assert pcfg.latent == 576 and pcfg.first_dense == 1


@pytest.mark.parametrize("fault", [None, _token_altered],
                         ids=["sound", "token_altered"])
def test_run_is_judged(tiny_bench, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res = harness.run_cell(tiny_bench, CELL, 31, 4.0, False, "cpu")
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def _served(rounds):
    """A returned call whose program kept round counters (per MoE layer,
    experts touched and pairs, cumulative)."""
    from mpi_acx_torch.models.serving import ServedBatch, ServingMetrics
    out = ServedBatch([], ServingMetrics())
    out.round_counters = rounds
    return dict(out=out)


def _art(op_names, durations, launches, spans, calls, steps, chunk=2):
    n = len(op_names)
    start = np.arange(n, dtype=np.int64) * 10 ** 7
    tr = Trace((0, 10 ** 9), list(op_names), start,
               start + np.asarray(durations, dtype=np.int64),
               np.asarray(launches, dtype=np.int64),
               {k: (np.asarray(a), np.asarray(b))
                for k, (a, b) in spans.items()})
    cfg = json.loads((BENCH / "configs" / "deepseek-v2-lite.json")
                     .read_text())
    return SimpleNamespace(kind="serve", trace=tr, dims=flops.dims(cfg),
                           chunk=chunk, calls=calls, k2_steps=steps)


def _spans(n_steps):
    starts = np.arange(n_steps) * 10 ** 6
    return {"decode_step": (starts, starts + 10 ** 6 - 1),
            "window": (np.array([0]), np.array([10 ** 9]))}


def test_readers_of_the_new_kernels():
    # Three traced steps at 64 slots; each step launches one split and one
    # combine kernel of the MLA decode (0.2 ms each) and both expert
    # kernels (6 ms each); an unrelated kernel is not counted.
    names, dur, launch = [], [], []
    for s in range(3):
        for name, us in (("_mla_decode_split_kernel_0d1d", 200),
                         ("_mla_decode_combine_kernel", 200),
                         ("_moe_experts_gate_up_kernel", 6000),
                         ("_moe_experts_down_kernel", 6000),
                         ("ampere_bf16_gemm", 500)):
            names.append(name)
            dur.append(us * 1000)
            launch.append(s * 10 ** 6 + 5)
    rounds = [[[0, 0]] * 26, [[128, 768]] * 26]      # 2 steps: 64 a layer
    art = _art(names, dur, launch, _spans(3), [_served(rounds)],
               [(64 * 300, 64)] * 3)
    experts = harness.Bench().metric("moe_experts_ms.serve").read(art)
    assert experts == pytest.approx(12.0)
    share = harness.Bench().metric("moe_roofline.serve").read(art)
    want_bytes = 128 * 26 * 3 * 2048 * 1408 * 2 + 2 * 26 * 64 * 2048 * 4
    assert share == pytest.approx(
        100 * want_bytes / 3.35e12 * 1e3 / 36.0, rel=1e-9)
    mla = harness.Bench().metric("mla_decode_roofline.serve").read(art)
    fl, nb = deepseek_cost.mla_decode_cost(64 * 300, 64, 16, 512, 64)
    assert mla == pytest.approx(
        100 * 27 * 3 * nb / 3.35e12 * 1e3 / 1.2, rel=1e-9)
    assert 0 < mla < 100 and 0 < share < 100


def test_readers_find_nothing_without_the_kernels_or_counters():
    names = ["decode_kernel", "ampere_bf16_gemm"]
    art = _art(names, [1000, 1000], [5, 5], _spans(1),
               [dict(out=SimpleNamespace())],
               [(100, 4)])
    for m in ("mla_decode_roofline.serve", "moe_experts_ms.serve",
              "moe_roofline.serve"):
        assert harness.Bench().metric(m).read(art) is None
    art = _art(["_moe_experts_down_kernel"], [1000], [5], _spans(1),
               [dict(out=SimpleNamespace())],
               [(100, 4)])
    assert harness.Bench().metric("moe_roofline.serve").read(art) is None


def test_a_round_the_trace_cut_is_left_out():
    # 5 traced steps, rounds of 2: the third round is cut after one step.
    rounds = [[[0, 0]], [[3, 6]], [[7, 12]], [[9, 18]]]
    art = _art(["x"], [1], [5], _spans(5), [_served(rounds)], [(4, 2)] * 5)
    assert deepseek_cost.traced_rounds(art) == (7, 12, 4)
    art = _art(["x"], [1], [5], _spans(8),
               [_served(rounds[:2]), _served(rounds[1:])], [(4, 2)] * 8)
    assert deepseek_cost.traced_rounds(art) == (9, 18, 6)


def test_cost_functions_count_the_work_once():
    # 100 live rows over 2 slots, 16 heads of 512 + 64: each row read once.
    fl, nb = deepseek_cost.mla_decode_cost(100, 2, 16, 512, 64)
    assert nb == 100 * 576 * 2 + 2 * 16 * (576 + 512) * 2
    assert fl == 2 * 16 * 100 * (576 + 512)
    # 5 touched experts, 12 pairs of 4 tokens: weights once, rows in and out.
    fl, nb = deepseek_cost.moe_cost(5, 12, 4, 2048, 1408)
    assert fl == 12 * 6 * 2048 * 1408
    assert nb == 5 * 3 * 2048 * 1408 * 2 + 4 * 2048 * 4
