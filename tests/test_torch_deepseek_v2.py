"""DeepSeek-V2 in the port (``models/deepseek_v2.py``, ``ops/mla.py``,
``ops/moe_experts.py``) against the plain reference
``acxbench/reference/deepseek_v2.py`` on seeded random weights at a tiny
size, in float32 on the CPU (the kernels' plain versions run): prefill
logits; prefill then decoding through the latent cache against the
reference's full forward; the absorbed decode against the non-absorbed
form; YaRN's frequencies and scale against the published formula; routing
that drops no token and breaks ties toward the lower expert;
``serve_greedy(family=deepseek_v2)`` against ``generate``.

Tests marked ``chip`` need a CUDA device and skip without one; run them
there with ``python -m pytest --noconftest -m chip
tests/test_torch_deepseek_v2.py``: each kernel against its plain version at
the published attention and expert widths, and a served run through the
captured step against ``generate``.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acxbench.families import deepseek_v2 as fam
from acxbench.reference import deepseek_v2 as ref
from acxbench.reference.common import exact_f32, matmul
from mpi_acx_torch.models import deepseek_v2 as ds
from mpi_acx_torch.models import serving
from mpi_acx_torch.ops import mla
from mpi_acx_torch.ops import moe_experts as mx

DATA = Path(__file__).resolve().parents[1] / "acxbench" / "tests" / "data"
LITE = Path(__file__).resolve().parents[1] / "acxbench" / "configs"


def _tiny(seed=3, dtype=torch.float32):
    cfg = json.loads((DATA / "tiny-deepseek-v2.json").read_text())
    return (cfg, fam.draw_params(cfg, seed, "cpu", dtype),
            fam.port_config(cfg, dtype))


def _ref_logits(params, cfg, tokens):
    with exact_f32():
        return ref.logits_at(params, cfg, tokens, torch.arange(len(tokens)),
                             matmul("f32"))


# -- YaRN, transcribed from modeling_deepseek.py ----------------------------


def _published_inv_freq(dim, base, factor, orig, beta_fast, beta_slow):
    def find_dim(num_rot):
        return (dim * math.log(orig / (num_rot * 2 * math.pi))) / (
            2 * math.log(base))
    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)
    lo, hi = low, high
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - lo)
                       / (hi - lo), 0, 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def _published_rope(x, positions, inv_freq, mscale):
    """apply_rotary_pos_emb of modeling_deepseek.py: the interleaved pairs
    taken apart, then rotate_half, cos and sin times the attention
    factor."""
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos() * mscale, emb.sin() * mscale
    *lead, S, H, d = x.shape
    x = x.reshape(*lead, S, H, d // 2, 2).transpose(-1, -2).reshape(
        *lead, S, H, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    rot = torch.cat((-x2, x1), dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


@pytest.mark.parametrize("which", ["lite", "tiny"])
def test_yarn_frequencies_and_scale_match_published(which):
    if which == "lite":
        cfg = json.loads((LITE / "deepseek-v2-lite.json").read_text())
        pcfg = fam.port_config(cfg, torch.float32)
    else:
        cfg, _, pcfg = _tiny()
    rs = cfg["rope_scaling"]
    want = _published_inv_freq(cfg["qk_rope_head_dim"], cfg["rope_theta"],
                                rs["factor"],
                                rs["original_max_position_embeddings"],
                                rs["beta_fast"], rs["beta_slow"])
    got = ds.yarn_inv_freq(pcfg.qk_rope, pcfg.rope_theta, pcfg.rope_factor,
                           pcfg.rope_original, pcfg.beta_fast,
                           pcfg.beta_slow)
    assert torch.equal(got, want)
    assert torch.equal(ref.inv_freq(cfg), want)
    # The ramp lies inside the rope dims: neither all extrapolated nor all
    # interpolated.
    base = cfg["rope_theta"] ** (-torch.arange(0, pcfg.qk_rope, 2) /
                                 pcfg.qk_rope)
    assert (want < base * 0.99).any() and torch.allclose(want[0], base[0])
    m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1
    scale = (pcfg.q_head ** -0.5) * m * m
    assert pcfg.scale == pytest.approx(scale, rel=1e-12)
    assert ref.softmax_scale(cfg) == pytest.approx(scale, rel=1e-12)
    if which == "lite":
        assert m == pytest.approx(1.2608, abs=1e-4)


def test_rope_is_published_rope_under_column_permutation():
    """The port pairs dims (i, i + D/2), the published code interleaves
    pairs: the same map once the rope columns are permuted (even ones,
    then odd ones)."""
    cfg, _, pcfg = _tiny()
    rs = cfg["rope_scaling"]
    D = pcfg.qk_rope
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 200, 3, D, generator=g)
    pos = torch.arange(200)
    inv = _published_inv_freq(D, cfg["rope_theta"], rs["factor"],
                              rs["original_max_position_embeddings"],
                              rs["beta_fast"], rs["beta_slow"])
    mscale = (ds.yarn_mscale(rs["factor"], rs["mscale"])
              / ds.yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    want = _published_rope(x[0], pos, inv, mscale)
    perm = torch.cat([torch.arange(0, D, 2), torch.arange(1, D, 2)])
    got = ds.rope(pcfg, x[..., perm], pos)[0]
    assert torch.allclose(got, want, atol=1e-5)


# -- the model against the reference ----------------------------------------


def test_prefill_logits_match_reference():
    cfg, params, pcfg = _tiny()
    tokens = torch.randint(0, pcfg.vocab, (40,),
                           generator=torch.Generator().manual_seed(1))
    want = _ref_logits(params, cfg, tokens)
    got, cache = ds.prefill(params, pcfg, tokens[None], 64)
    assert torch.allclose(got[0], want, atol=2e-5, rtol=1e-4)
    assert cache["k"].shape == (3, 1, 64, 1, pcfg.latent)
    assert int(cache["pos"]) == 40 and "v" not in cache
    assert torch.equal(ds.forward(params, pcfg, tokens[None])[0], got[0])


def test_decode_through_latent_cache_matches_reference_forward():
    """Prefill 10 tokens, then decode 20 through the latent cache (the
    absorbed form): every step's logits equal the reference's full
    non-absorbed forward at that position."""
    cfg, params, pcfg = _tiny(seed=4)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, pcfg.vocab, (2, 30), generator=g)
    _, cache = ds.prefill(params, pcfg, tokens[:, :10], 48)
    for s in range(10, 30):
        logits, cache = ds.decode_step(params, pcfg, cache, tokens[:, s])
        for b in range(2):
            want = _ref_logits(params, cfg, tokens[b, :s + 1])[-1]
            assert torch.allclose(logits[b], want, atol=2e-5, rtol=1e-4), s
    assert int(cache["pos"]) == 30
    steps = cache["counts"]
    assert (steps[:, 1] == 20 * 2 * pcfg.top_k).all()
    assert ((steps[:, 0] >= 20) & (steps[:, 0] <= 20 * pcfg.n_experts)).all()


def test_absorbed_decode_equals_non_absorbed_form():
    """One layer's attention output at the last of 25 positions: the
    latent query against the cached rows, then W_UV, equals per-head K of
    192 and V of 128."""
    _, params, pcfg = _tiny(seed=5)
    lp = ds._layer(params, pcfg, 1)
    x = torch.randn(1, 25, pcfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    q, row = ds._q_and_row(pcfg, lp, x, torch.arange(25))
    want = ds._attend_prefill(pcfg, lp, q, row)[:, -1:]
    q_lat = ds._absorb_query(pcfg, lp, q[:, -1:])
    o_lat = mla.mla_decode_reference(q_lat, row[:, :, None, :],
                                     torch.tensor([24]), pcfg.scale,
                                     pcfg.kv_lora)
    got = ds._unabsorb(pcfg, lp, o_lat)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-4)


def test_latent_decode_masks_rows_past_each_slot():
    g = torch.Generator().manual_seed(6)
    q = torch.randn(3, 1, 4, 40, generator=g)
    rows = torch.randn(3, 16, 1, 40, generator=g)
    pos = torch.tensor([0, 7, 15])
    got = mla.mla_decode_reference(q, rows, pos, 0.3, 32)
    junk = rows.clone()
    for b, p in enumerate(pos.tolist()):
        junk[b, p + 1:] = 1e3
    assert torch.equal(mla.mla_decode_reference(q, junk, pos, 0.3, 32), got)
    for b, p in enumerate(pos.tolist()):
        keys = rows[b, :p + 1, 0]
        w = torch.softmax((q[b, 0] @ keys.T) * 0.3, dim=-1)
        assert torch.allclose(got[b, 0], w @ keys[:, :32], atol=1e-6)


def test_prefill_attention_has_its_own_value_width():
    g = torch.Generator().manual_seed(7)
    q, k = torch.randn(2, 2, 9, 3, 24, generator=g)
    v = torch.randn(2, 9, 3, 16, generator=g)
    got = mla.mla_attention_reference(q, k, v, 0.2)
    assert got.shape == (2, 9, 3, 16)
    for s in range(9):
        w = torch.softmax(torch.einsum("bhd,bkhd->bhk", q[:, s],
                                       k[:, :s + 1]) * 0.2, dim=-1)
        assert torch.allclose(got[:, s], torch.einsum(
            "bhk,bkhd->bhd", w, v[:, :s + 1]), atol=1e-6)


# -- routing ----------------------------------------------------------------


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def test_routing_drops_no_token_when_every_token_picks_one_expert():
    """Every token's largest probability is expert 3's and k = 1: all 50
    pairs land on one expert, none is dropped, each row is that expert's
    SwiGLU times its probability."""
    g = torch.Generator().manual_seed(8)
    T, d, E, I = 50, 16, 8, 12
    x = torch.randn(T, d, generator=g).abs() + 0.1
    router = torch.zeros(d, E)
    router[:, 3] = 1.0
    ids, w = mx.route(x, router, 1)
    assert (ids == 3).all()
    counts = mx.expert_counts(ids, E)
    assert counts.tolist() == [0, 0, 0, T, 0, 0, 0, 0]
    wg, wu = torch.randn(2, E, d, I, generator=g)
    wd = torch.randn(E, I, d, generator=g)
    got = mx.routed_experts(x, ids, w, mx.expert_counts(ids, wg.shape[0]),
                            wg, wu, wd)
    want = _swiglu(x, wg[3], wu[3], wd[3]) * w
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got.abs().sum(1) > 0).all()


def test_router_ties_go_to_the_lower_expert():
    d, E = 8, 8
    router = torch.zeros(d, E)
    router[:, [1, 4, 6]] = 0.5          # three experts tied at the top
    x = torch.ones(5, d)
    ids, w = mx.route(x, router, 2, scale=2.0)
    assert ids.tolist() == [[1, 4]] * 5
    p = torch.softmax(x[0] @ router, dim=-1)
    assert torch.allclose(w, (p[[1, 4]] * 2.0).expand(5, 2))
    ids, _ = mx.route(x, torch.zeros(d, E), 6)
    assert ids.tolist() == [list(range(6))] * 5


def test_routed_experts_plain_equals_per_token_sum():
    g = torch.Generator().manual_seed(9)
    T, d, E, I, K = 20, 16, 8, 12, 3
    x = torch.randn(T, d, generator=g)
    ids, w = mx.route(x, torch.randn(d, E, generator=g), K)
    wg, wu = torch.randn(2, E, d, I, generator=g)
    wd = torch.randn(E, I, d, generator=g)
    got = mx.routed_experts(x, ids, w, mx.expert_counts(ids, wg.shape[0]),
                            wg, wu, wd)
    for t in range(T):
        want = sum(w[t, j] * _swiglu(x[t], wg[e], wu[e], wd[e])
                   for j, e in enumerate(ids[t].tolist()))
        assert torch.allclose(got[t], want, atol=1e-4, rtol=1e-5)


# -- serving ----------------------------------------------------------------


def _requests(vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(m), dtype=np.int32)
               for m in rng.integers(2, 20, n)]
    return prompts, [int(m) for m in rng.integers(1, 12, n)]


def _tie_or_equal(params, pcfg, prompt, got, n):
    """``got`` equals the solo ``generate`` run, or departs from it only
    where the solo run's two candidates are tied within bf16 rounding."""
    want = ds.generate(params, pcfg, torch.tensor(prompt)[None], n,
                       device="cpu")[0].numpy()
    if np.array_equal(got, want):
        return True
    i = int(np.argmax(got != want))
    logits = ds.forward(params, pcfg, torch.tensor(want[:i])[None])[0, -1]
    return float(logits[want[i]] - logits[got[i]]) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_serve_greedy_matches_generate(dtype):
    _, params, pcfg = _tiny(seed=6, dtype=dtype)
    prompts, n_new = _requests(pcfg.vocab)
    fns = serving.make_server_fns(params, pcfg, ds, chunk=2)
    for _ in range(2):
        out = serving.serve_greedy(params, pcfg, prompts, n_new, 3, 64,
                                   family=ds, chunk=2, server_fns=fns,
                                   device="cpu")
        for p, n, got in zip(prompts, n_new, out):
            assert len(got) == len(p) + n
            if dtype == torch.float32:
                want = ds.generate(params, pcfg, torch.tensor(p)[None], n,
                                   device="cpu")[0].numpy()
                assert np.array_equal(got, want)
            else:
                assert _tie_or_equal(params, pcfg, p, got, n)
    rc = np.array(out.round_counters)
    assert rc.shape == (out.metrics.steps + 1, pcfg.n_moe, 2)
    per_round = np.diff(rc, axis=0)
    assert (per_round[..., 1] == 2 * 3 * pcfg.top_k).all()
    assert (per_round[..., 0] >= 2).all()


def test_int8_cache_and_paged_server_are_refused():
    _, params, pcfg = _tiny()
    with pytest.raises(ValueError, match="kv_int8"):
        ds.init_kv_cache(pcfg, 2, 16, kv_int8=True, device="cpu")
    prompts, n_new = _requests(pcfg.vocab, n=2)
    with pytest.raises(ValueError, match="latent cache"):
        serving.serve_paged_greedy(params, pcfg, prompts, n_new, 2, 64,
                                   family=ds, device="cpu")


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _card_config():
    """The published attention and expert widths (16 heads, 512 + 64
    latent, 192/128, experts of 1408) in a short, narrow model."""
    return dataclasses.replace(
        ds.deepseek_v2_lite(), vocab=512, d_model=256, n_layers=3, d_ff=512,
        n_experts=8, top_k=3, max_seq=4096)


@pytest.mark.chip
def test_kernels_match_plain_versions_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    scale = mla.softmax_scale(192, 40.0, 0.707)
    q, k = (torch.randn(2, 77, 16, 192, generator=g, device=cuda)
            .bfloat16() for _ in range(2))
    v = torch.randn(2, 77, 16, 128, generator=g, device=cuda).bfloat16()
    got = mla.mla_flash_attention(q, k, v, scale)
    want = mla.mla_attention_reference(q.float(), k.float(), v.float(),
                                       scale)
    assert (got.float() - want).abs().max() < 2e-2
    ql = torch.randn(8, 1, 16, 576, generator=g, device=cuda).bfloat16()
    rows = torch.randn(8, 600, 1, 576, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([0, 1, 127, 128, 129, 300, 598, 599], device=cuda,
                       dtype=torch.int32)
    got = mla.mla_decode_attend(ql, rows, pos, scale, 512)
    want = mla.mla_decode_reference(ql.float(), rows.float(), pos, scale,
                                    512)
    assert (got.float() - want).abs().max() < 2e-2
    x = torch.randn(70, 256, generator=g, device=cuda).bfloat16()
    wg, wu = (torch.randn(8, 256, 1408, generator=g, device=cuda)
              .mul(0.05).bfloat16() for _ in range(2))
    wd = torch.randn(8, 1408, 256, generator=g, device=cuda).mul(
        0.05).bfloat16()
    ids, w = mx.route(x, torch.randn(256, 8, generator=g, device=cuda), 3)
    got = mx.routed_experts(x, ids, w, mx.expert_counts(ids, wg.shape[0]),
                            wg, wu, wd)
    want = mx.routed_experts_reference(x, ids, w, wg, wu, wd)
    assert torch.allclose(got, want, atol=2e-3, rtol=2e-2)


@pytest.mark.chip
def test_served_through_captured_step_matches_generate_cuda(cuda):
    pcfg = _card_config()
    params = ds.init_params(pcfg, 3, cuda, torch.bfloat16)
    prompts, n_new = _requests(pcfg.vocab, n=9, seed=1)
    fns = serving.make_server_fns(params, pcfg, ds, chunk=2)
    for _ in range(2):
        out = serving.serve_greedy(params, pcfg, prompts, n_new, 4, 128,
                                   family=ds, chunk=2, server_fns=fns)
    for p, n, got in zip(prompts, n_new, out):
        want = ds.generate(params, pcfg, torch.tensor(p)[None], n,
                           max_len=128)[0].cpu().numpy()
        i = int(np.argmax(got != want)) if not np.array_equal(got,
                                                               want) else -1
        if i >= 0:
            lg = ds.forward(params, pcfg, torch.tensor(
                want[:i], device=cuda)[None])[0, -1]
            assert float(lg[want[i]] - lg[got[i]]) < 0.1
    gr = fns.slots.cache.graphs
    assert gr.captures == 1 and gr.eager == 1 and gr.replayed > 0
    assert mla.mla_decode_attend.launches > 0
    assert mx.routed_experts.launches > 0
