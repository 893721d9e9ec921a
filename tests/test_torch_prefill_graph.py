"""The served prefill replayed from CUDA graphs between its attention calls
(``models/decoding.py``: ``run_prefill``, ``PrefillGraphs``).

On the CPU the segmented prompt pass runs eagerly and is held bit for bit
to the monolithic pass it replaced (a layer loop, then the cache filled
from the stacked K/V): GPT-2, a small Llama with GQA, the MoE transformer
and DeepSeek-V2's latent cache, bf16 and int8 caches, at a real length
below the bucket, both as a plain call (a fresh cache) and seated in a
slot of the serve loop's cache. ``serve_greedy`` over prompts in three
buckets still equals ``generate``; only the fixed-slot server's prefill
reaches the runner; a prefill that raises re-queues its request and drops
the captures. With the capture cap (``decoding.PREFILL_CAPTURE_MAX``)
lowered to 16, prompts above it are served unpadded, counted ``exact``,
to the tokens of the all-padded path (the fixed-slot and paged servers).

Tests marked ``chip`` need a CUDA device and skip without one; run them on
the card with ``python -m pytest --noconftest -m chip
tests/test_torch_prefill_graph.py`` (``tests/conftest.py`` imports JAX):
each bucket's first seated pass captures (the first after a warm pass),
the others replay, and every pass's logits and slot rows equal a plain
pass's bit for bit; prompts of 1500 and 1501 tokens run at their own
length, uncaptured, near their pass padded to 2048.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_acx_torch.models import decoding, serving
from mpi_acx_torch.models import deepseek_v2 as ds
from mpi_acx_torch.models import llama as lm
from mpi_acx_torch.models import moe_transformer as moe
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.ops import mla
from mpi_acx_torch.ops.wquant import wread

FAMILIES = {"gpt2": tfm, "llama": lm, "moe": moe, "deepseek": ds}
KEYS = ("k", "v", "ks", "vs")
CASES = [(f, kv) for f in FAMILIES for kv in (False, True)
         if not (f == "deepseek" and kv)]      # DeepSeek's cache is bf16


def _model(family, dev, dtype=torch.bfloat16, head_dim=16):
    """A small model of ``family`` computing in ``dtype``: f32 weights on
    the CPU, bf16 weights on the card (as the benchmark serves)."""
    if family == "gpt2":
        cfg = tfm.tiny_config(vocab=97, d_model=2 * head_dim, n_heads=2,
                              n_layers=3, d_ff=64, max_seq=128)
        params = tfm.init_params(cfg, seed=0, device=dev)
    elif family == "llama":
        cfg = lm.tiny_llama(vocab=97, d_model=4 * head_dim, n_heads=4,
                            n_kv_heads=2, n_layers=3, d_ff=64, max_seq=128)
        params = lm.init_params(cfg, seed=0, device=dev)
    elif family == "moe":
        cfg = moe.tiny_moe_config(vocab=97, d_model=2 * head_dim,
                                  n_heads=2, n_layers=2, d_ff=32,
                                  n_experts=4, capacity_factor=4.0,
                                  max_seq=128)
        params = moe.init_params(cfg, seed=0, device=dev)
    elif torch.device(dev).type == "cuda":
        # The kernels' widths: 16 heads of 192/128 over a 512 + 64 latent
        # row, experts of 1408 (as tests/test_torch_deepseek_v2.py).
        cfg = dataclasses.replace(
            ds.deepseek_v2_lite(), vocab=512, d_model=256, n_layers=3,
            d_ff=512, n_experts=8, top_k=3, max_seq=4096)
        params = ds.init_params(cfg, seed=0, device=dev)
    else:
        cfg = ds.tiny_deepseek_v2(max_seq=128)
        params = ds.init_params(cfg, seed=0, device=dev)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if torch.device(dev).type == "cuda":
        params = tfm.cast_params(params, torch.bfloat16)
    return FAMILIES[family], cfg, params


def _monolithic(family, params, cfg, tokens, max_len, kv_int8, last):
    """The prompt pass as one layer loop, the cache filled from the stacked
    rows afterwards: (logits of row ``last``, cache)."""
    B, S = tokens.shape
    with torch.no_grad():
        if family == "deepseek":
            x = params["embed"][tokens].to(cfg.dtype)
            positions = torch.arange(S)
            rows = []
            for i in range(cfg.n_layers):
                lp = ds._layer(params, cfg, i)
                q, row = ds._q_and_row(cfg, lp, x, positions)
                x = x + ds._attend_prefill(cfg, lp, q, row) @ lp["wo"].to(
                    x.dtype)
                x = ds._ffn(cfg, lp, x)
                rows.append(row)
            x = lm.rmsnorm(x, params["final_norm"], cfg.rms_eps)
            logits = tfm._unembed(x[:, last:last + 1], params["unembed"])
            cache = ds.init_kv_cache(cfg, B, max_len, device="cpu")
            cache["k"][:, :, :S, 0] = torch.stack(rows)
            cache["pos"] = torch.full((), S, dtype=torch.int32)
            return logits, cache
        ks, vs = [], []
        if family == "llama":
            x = params["embed"][tokens].to(cfg.dtype)
            positions = torch.arange(S)
            for i in range(cfg.n_layers):
                lp = lm._layer(params, i)
                q, k, v = lm._qkv(cfg, lp, x, positions)
                x = x + lm._attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
                x = lm._mlp(cfg, lp, x)
                ks.append(k)
                vs.append(v)
            x = lm.rmsnorm(x, params["final_norm"])
            logits = tfm._unembed(x[:, last:last + 1], params["unembed"])
        else:
            ffn = moe._moe_ffn if family == "moe" else tfm._mlp
            x = (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)
            for i in range(cfg.n_layers):
                lp = tfm._layer(params, i)
                q, k, v = tfm._qkv(cfg, lp, x)
                x = x + tfm._attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
                x = ffn(cfg, lp, x)
                ks.append(k)
                vs.append(v)
            x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
            logits = tfm._unembed(x[:, last:last + 1], params["embed"])
        fam = FAMILIES[family]
        cache = decoding.fill_kv_cache(
            fam.init_kv_cache(cfg, B, max_len, kv_int8=kv_int8,
                              device="cpu"),
            torch.stack(ks), torch.stack(vs), S)
        return logits, cache


def _padded(vocab, real, bucket, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :real] = torch.randint(0, vocab, (real,), generator=g)
    return tokens


@pytest.mark.parametrize("family,kv_int8", CASES,
                         ids=[f"{f}-{'int8' if kv else 'bf16'}"
                              for f, kv in CASES])
def test_segmented_prefill_equals_monolithic(family, kv_int8):
    """An 11-token prompt padded to 16: the plain call's logits and cache
    and the seated pass's logits and slot rows equal the monolithic
    pass's bit for bit; the other slots and every position keep theirs;
    the seated pass counts one eager pass of its bucket."""
    fam, cfg, params = _model(family, "cpu")
    tokens = _padded(cfg.vocab, 11, 16)
    want, wcache = _monolithic(family, params, cfg, tokens, 16, kv_int8, 10)

    got, cache = fam.prefill(params, cfg, tokens, 16, kv_int8=kv_int8,
                             last_index=10)
    assert torch.equal(want, got)
    assert set(cache) == set(wcache)
    for key in cache:
        assert torch.equal(wcache[key], cache[key]), key

    slots = serving.seat_slots(fam.init_kv_cache(cfg, 3, 32, kv_int8,
                                                 device="cpu"))
    for key in KEYS:
        if key in slots:
            slots[key].fill_(3)
    before = {k: t.clone() for k, t in slots.items()}
    got, out = fam.prefill(params, cfg, tokens, 16, kv_int8=kv_int8,
                           last_index=10, seat=(slots, 1))
    assert out is slots and torch.equal(want, got)
    for key in KEYS:
        if key in slots:
            assert torch.equal(slots[key][:, 1, :16], wcache[key][:, 0]), key
            assert torch.equal(slots[key][:, 1, 16:], before[key][:, 1, 16:])
            for b in (0, 2):
                assert torch.equal(slots[key][:, b], before[key][:, b])
    assert torch.equal(slots["pos"], before["pos"])
    pg = slots.prefills
    assert (pg.eager, pg.replayed, pg.captures) == (1, 0, 0)
    assert pg.buckets == {16: dict(replayed=0, eager=1, captures=0,
                                   exact=0)}

    # A slot cache the family's own step handed back as a plain dict.
    plain = {k: t.clone() for k, t in before.items()}
    got, out = fam.prefill(params, cfg, tokens, 16, kv_int8=kv_int8,
                           last_index=10, seat=(plain, 1))
    assert out is plain and torch.equal(want, got)
    for key in slots:
        assert torch.equal(plain[key], slots[key]), key


def _requests(vocab, seed=2):
    """Six prompts over the buckets 8, 16 and 32."""
    rng = np.random.default_rng(seed)
    lens = [3, 12, 8, 31, 9, 20]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts, [int(n) for n in rng.integers(1, 5, len(lens))]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_served_prefill_equals_generate(family):
    """f32 serving over 3 slots in chunks of 2: every request equals its
    solo ``generate``; each prefill ran the seated pass, by bucket."""
    fam, cfg, params = _model(family, "cpu", dtype=torch.float32)
    prompts, n_new = _requests(cfg.vocab)
    fns = serving.make_server_fns(params, cfg, fam, chunk=2)
    out = serving.serve_greedy(params, cfg, prompts, n_new, 3, 64,
                               family=fam, chunk=2, server_fns=fns,
                               device="cpu")
    for p, n, got in zip(prompts, n_new, out):
        want = fam.generate(params, cfg, torch.tensor(p)[None], n,
                            device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, want)
    pg = fns.slots.cache.prefills
    assert pg.eager == out.metrics.prefills == len(prompts)
    assert {b: n["eager"] for b, n in pg.buckets.items()} == {8: 2, 16: 2,
                                                              32: 2}
    assert (pg.replayed, pg.captures) == (0, 0)


@pytest.mark.parametrize("n,width", [(3, 8), (11, 16), (16, 16), (17, 17),
                                     (30, 30)])
def test_padded_keeps_long_prompts_at_their_length(monkeypatch, n, width):
    """With the capture cap at 16, a prompt of at most 16 tokens is padded
    with zeros to its power-of-two bucket and a longer one keeps its own
    length; the disaggregated servers' ``_bucketed`` still pads it."""
    monkeypatch.setattr(decoding, "PREFILL_CAPTURE_MAX", 16)
    prompt = np.arange(1, n + 1, dtype=np.int32)
    got = serving._padded(prompt, 64, 128)
    assert got.dtype == np.int32 and got.shape == (1, width)
    np.testing.assert_array_equal(got[0, :n], prompt)
    assert not got[0, n:].any()
    assert serving._bucketed(prompt, 64, 128).shape == (1, max(8, 1 << (
        n - 1).bit_length()))


def _shared_prefix_requests(vocab, seed=3):
    """Prompts for the paged server with a prefix cache: two share their
    first 16 tokens (two pages of 8) before suffixes of 20 and 5."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 16)
    prompts = [np.concatenate([head, rng.integers(0, vocab, 20)]),
               np.concatenate([head, rng.integers(0, vocab, 5)]),
               rng.integers(0, vocab, 27), rng.integers(0, vocab, 4)]
    return [p.astype(np.int32) for p in prompts], [3, 4, 2, 3]


SERVERS = [(f, "fixed") for f in FAMILIES] + [("gpt2", "paged")]


@pytest.mark.parametrize("family,server", SERVERS,
                         ids=[f"{f}-{s}" for f, s in SERVERS])
def test_long_prompts_served_at_their_length(monkeypatch, family, server):
    """f32 serving with the capture cap at 16: prompts above it (31 and 20
    tokens; on the paged server a 36-token cold prompt and a 20-token
    suffix after a two-page prefix hit) give the tokens of the all-padded
    path (the cap at its own value); the fixed-slot server's capture state
    counts them ``exact`` under their own lengths, the others ``eager``
    under their buckets, and captures nothing."""
    fam, cfg, params = _model(family, "cpu", dtype=torch.float32)
    kw = dict(n_slots=3, max_len=64, chunk=2, device="cpu")
    if server == "paged":
        prompts, n_new = _shared_prefix_requests(cfg.vocab)

        def serve():
            return serving.serve_paged_greedy(
                params, cfg, prompts, n_new, page_tokens=8,
                prefix_cache=True, **kw)
    else:
        prompts, n_new = _requests(cfg.vocab)
        fns = serving.make_server_fns(params, cfg, fam, chunk=2)

        def serve():
            return serving.serve_greedy(params, cfg, prompts, n_new,
                                        family=fam, server_fns=fns, **kw)
    want = serve()
    monkeypatch.setattr(decoding, "PREFILL_CAPTURE_MAX", 16)
    got = serve()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    if server == "paged":
        assert got.metrics.prefix_hits == want.metrics.prefix_hits == 1
        return
    pg = fns.slots.cache.prefills
    assert {b: n["exact"] for b, n in pg.buckets.items()} == {
        8: 0, 16: 0, 32: 0, 31: 1, 20: 1}
    assert {b: n["eager"] for b, n in pg.buckets.items()} == {
        8: 4, 16: 4, 32: 2, 31: 0, 20: 0}
    assert (pg.exact, pg.captures, pg.replayed) == (2, 0, 0)


def test_only_the_served_prefill_reaches_the_runner(monkeypatch):
    """A plain ``prefill``, ``generate``, the paged server and a plain
    server-fns tuple never reach the seated pass; ``serve_greedy`` with a
    ``make_server_fns`` result does, once a prefill."""
    calls = []
    run = decoding.PrefillGraphs.run

    def counted(self, *a, **kw):
        calls.append(1)
        return run(self, *a, **kw)

    monkeypatch.setattr(decoding.PrefillGraphs, "run", counted)
    fam, cfg, params = _model("gpt2", "cpu", dtype=torch.float32)
    prompts, n_new = _requests(cfg.vocab)
    tfm.prefill(params, cfg, _padded(cfg.vocab, 5, 8), 8, last_index=4)
    tfm.generate(params, cfg, torch.tensor(prompts[0])[None], 3,
                 device="cpu")
    serving.serve_paged_greedy(params, cfg, prompts, n_new, n_slots=3,
                               max_len=64, chunk=2, page_tokens=8,
                               device="cpu")
    serving.serve_greedy(params, cfg, prompts, n_new, 3, 64, chunk=2,
                         server_fns=tuple(serving.make_server_fns(
                             params, cfg, tfm, chunk=2)), device="cpu")
    assert calls == []
    out = serving.serve_greedy(params, cfg, prompts, n_new, 3, 64, chunk=2,
                               device="cpu")
    assert len(calls) == out.metrics.prefills == len(prompts)


def test_seated_prefill_must_return_the_slot_cache():
    """A ``ServerFns`` prefill that ignores ``seat=`` and hands back a
    cache of its own fails its request loudly: the serve loop does not
    fall back to copying the rows."""
    fam, cfg, params = _model("gpt2", "cpu", dtype=torch.float32)
    prompts, n_new = _requests(cfg.vocab)
    fns = serving.make_server_fns(params, cfg, fam, chunk=2)

    def unseated(tokens, last, seat=None):
        return fns[0](tokens, last)

    bad = serving.ServerFns((unseated,) + tuple(fns[1:]))
    bad.slots = fns.slots
    with pytest.raises(RuntimeError, match="max_request_retries") as err:
        serving.serve_greedy(params, cfg, prompts, n_new, 3, 64, chunk=2,
                             server_fns=bad, max_request_retries=0,
                             device="cpu")
    assert isinstance(err.value.__cause__, TypeError)


def test_failed_prefill_requeues_and_drops_the_captures():
    """A prefill that raises on its third call re-queues its request,
    which replays to the same tokens, and drops the slot cache's decode
    and prefill captures (planted here, as a CPU pass captures none)."""
    fam, cfg, params = _model("llama", "cpu", dtype=torch.float32)
    prompts, n_new = _requests(cfg.vocab)
    kw = dict(n_slots=3, max_len=64, chunk=2, device="cpu")
    fns = serving.make_server_fns(params, cfg, fam, chunk=2)
    want = serving.serve_greedy(params, cfg, prompts, n_new, family=fam,
                                server_fns=fns, **kw)
    cache = fns.slots.cache
    cache.prefills._caps, cache.prefills._key = {8: "planted"}, "planted"
    cache.graphs._key = "planted"
    calls = {"n": 0}

    def failing(tokens, last, seat=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("device prefill failed")
        return fns[0](tokens, last, seat=seat)

    bad = serving.ServerFns((failing,) + tuple(fns[1:]))
    bad.slots = fns.slots
    got = serving.serve_greedy(params, cfg, prompts, n_new, family=fam,
                               server_fns=bad, max_request_retries=1, **kw)
    assert got.metrics.requeues == 1 and calls["n"] == len(prompts) + 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert fns.slots.cache is cache
    assert cache.prefills._caps == {} and cache.prefills._key is None
    assert cache.graphs._key is None


def test_attention_writes_into_out():
    """The prefill attention's ``out=``: the plain versions on the CPU
    write the buffer they return, equal to the call without it; a call
    that takes a gradient refuses it."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, 2, 16, generator=g) for _ in range(3))
    buf = torch.empty_like(q)
    assert tattn.flash_attention(q, k, v, out=buf) is buf
    assert torch.equal(buf, tattn.flash_attention(q, k, v))
    vm = torch.randn(1, 9, 2, 8, generator=g)
    mbuf = torch.empty_like(vm)
    assert mla.mla_flash_attention(q, k, vm, 0.3, out=mbuf) is mbuf
    assert torch.equal(mbuf, mla.mla_flash_attention(q, k, vm, 0.3))
    with pytest.raises(ValueError, match="no gradient"):
        tattn.flash_attention(q.requires_grad_(), k, v, out=buf)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.chip
@pytest.mark.parametrize("family,kv_int8", CASES,
                         ids=[f"{f}-{'int8' if kv else 'bf16'}"
                              for f, kv in CASES])
def test_captured_prefill_equals_plain_cuda(cuda, family, kv_int8):
    """Eight seated passes over two buckets at head dim 64 (DeepSeek's
    own widths: 192/128) through K1: the first pass is the warm pass and
    the capture of its bucket, the other bucket's first pass captures and
    replays, the later ones replay; every pass's logits and slot rows
    equal a plain pass's bit for bit."""
    fam, cfg, params = _model(family, cuda, head_dim=64)
    slots = serving.seat_slots(fam.init_kv_cache(cfg, 4, 128, kv_int8,
                                                 device=cuda))
    for n, (real, bucket) in enumerate([(5, 8), (30, 32), (8, 8), (17, 32),
                                        (2, 8), (32, 32), (7, 8), (25, 32)]):
        tokens = _padded(cfg.vocab, real, bucket, seed=n).to(cuda)
        want, wcache = fam.prefill(params, cfg, tokens, bucket,
                                   kv_int8=kv_int8, last_index=real - 1)
        got, _ = fam.prefill(params, cfg, tokens, bucket, kv_int8=kv_int8,
                             last_index=real - 1, seat=(slots, n % 4))
        assert torch.equal(want, got), (n, (want - got).abs().max())
        for key in KEYS:
            if key in slots:
                assert torch.equal(slots[key][:, n % 4, :bucket],
                                   wcache[key][:, 0]), (n, key)
    pg = slots.prefills
    assert (pg.eager, pg.replayed, pg.captures) == (1, 7, 2)
    assert pg.buckets == {8: dict(replayed=3, eager=1, captures=1, exact=0),
                          32: dict(replayed=4, eager=0, captures=1, exact=0)}


@pytest.mark.chip
@pytest.mark.parametrize("family", ["gpt2", "llama", "deepseek"])
def test_served_tokens_with_captured_prefill_cuda(cuda, family):
    """Two calls of one ``make_server_fns`` result serve the tokens of a
    plain prefill's server (a plain server-fns tuple: a fresh cache a
    prompt, scattered into its slot); the first call captures each bucket
    once (one warm pass in all), every other prefill replays."""
    fam, cfg, params = _model(family, cuda, head_dim=64)
    prompts, n_new = _requests(cfg.vocab)
    kw = dict(n_slots=3, max_len=64, chunk=2, device=cuda)
    want = serving.serve_greedy(
        params, cfg, prompts, n_new, family=fam, server_fns=tuple(
            serving.make_server_fns(params, cfg, fam, chunk=2)), **kw)
    fns = serving.make_server_fns(params, cfg, fam, chunk=2)
    for call in range(2):
        got = serving.serve_greedy(params, cfg, prompts, n_new, family=fam,
                                   server_fns=fns, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        pg = fns.slots.cache.prefills
        assert (pg.captures, pg.eager) == (3, 1)
        assert pg.replayed == (call + 1) * len(prompts) - 1


@pytest.mark.chip
def test_long_prompt_prefills_at_its_length_cuda(cuda):
    """A small bf16 Llama at head dim 128 (K1's served width) on the card:
    after a 1000-token prompt captures the 1024 bucket, prompts of 1500
    and 1501 tokens run their seated passes at their own length,
    uncaptured. Each pass's last-row logits are held to the family's
    ``forward`` over the prompt alone (one unsegmented pass, no cache):
    within K1's bf16 row error (``chip_smoke.TOL_ROW``, over the
    reference's RMS), the same first token or the reference's two within
    ``chip_smoke.TIE_LLAMA``. The long passes are also held, logits and
    slot rows, to the same prompt's pass padded to its 2048 bucket, and a
    served call of both long prompts gives ``forward``'s greedy tokens up
    to the first near tie."""
    import chip_smoke
    tol, tie = chip_smoke.TOL_ROW[torch.bfloat16], chip_smoke.TIE_LLAMA
    cfg = lm.tiny_llama(vocab=97, d_model=512, n_heads=4, n_kv_heads=2,
                        n_layers=3, d_ff=64, max_seq=2048)
    params = tfm.cast_params(lm.init_params(cfg, seed=0, device=cuda),
                             torch.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)

    def row_error(want, got):
        want, got = want.float(), got.float()
        return float((want - got).abs().max() / want.square().mean().sqrt())

    def same_or_tie(want, got):
        a, b = int(want.argmax()), int(got.argmax())
        return a == b or float(want[a] - want[b]) < tie

    fns = serving.make_server_fns(params, cfg, lm)
    slots = serving.seat_slots(lm.init_kv_cache(cfg, 2, 2048, device=cuda))
    rng = np.random.default_rng(4)
    prompts = {}
    with torch.no_grad():
        for n, real in enumerate((1000, 1500, 1501)):
            prompt = rng.integers(0, cfg.vocab, real).astype(np.int32)
            prompts[real] = prompt
            tok = torch.from_numpy(serving._padded(prompt, 2048,
                                                   cfg.max_seq)).to(cuda)
            assert tok.shape[1] == (1024 if real < 1024 else real)
            got = fns[0](tok, real - 1, seat=(slots, n % 2))[0][0, 0]
            ref = lm.forward(params, cfg, tok[:, :real])[0, -1]
            assert row_error(ref, got) <= tol, (real, row_error(ref, got))
            assert same_or_tie(ref.float(), got.float()), real
            if real < 1024:
                continue
            padded = torch.from_numpy(serving._bucketed(
                prompt, 2048, cfg.max_seq)).to(cuda)
            want, wcache = lm.prefill(params, cfg, padded, 2048,
                                      last_index=real - 1)
            assert row_error(want[0, 0], got) <= tol, real
            for key in ("k", "v"):
                w = wcache[key][:, 0, :real]
                assert row_error(w, slots[key][:, n % 2, :real]) <= tol, (
                    real, key)
    pg = slots.prefills
    assert (pg.eager, pg.captures, pg.exact) == (1, 1, 2)
    assert pg.buckets == {
        1024: dict(replayed=0, eager=1, captures=1, exact=0),
        1500: dict(replayed=0, eager=0, captures=0, exact=1),
        1501: dict(replayed=0, eager=0, captures=0, exact=1)}

    long = [prompts[1500], prompts[1501]]
    served = serving.serve_greedy(params, cfg, long, 4, n_slots=2,
                                  max_len=2048, family=lm, server_fns=fns,
                                  device=cuda)
    with torch.no_grad():
        for prompt, out in zip(long, served):
            seq = torch.from_numpy(prompt).to(cuda)[None]
            for t in out[len(prompt):].tolist():
                ref = lm.forward(params, cfg, seq)[0, -1].float()
                top = ref.topk(2).values
                if float(top[0] - top[1]) < tie:
                    break
                assert t == int(ref.argmax()), (len(prompt), seq.shape[1])
                seq = torch.cat([seq, seq.new_tensor([[t]])], 1)
    pg = fns.slots.cache.prefills
    assert (pg.exact, pg.captures, pg.replayed) == (2, 0, 0)
