"""The port's paged KV cache (mpi_acx_torch/models/kvpage.py) and B9's
plain version and wrapper (ops/flash_decode.py) held against the JAX
package (models/kvpage.py, ops/flash_decode.py).

Inputs come from a numpy seed and go through both packages. The paged
gather is bit-equal to JAX's (bf16 queries, bf16 or int8 pools: both
frameworks round the same bf16 products), and to the port's own dense
attention on the fixed cache the pages hold. B9's wrapper runs its plain
version on a CPU tensor and is held to JAX's paged Pallas kernel in
interpret mode: 4e-2 for bf16 (the JAX package's own bf16 decode limit:
the kernel keeps f32 logits and probabilities where the plain version
rounds them to bf16), 1e-5 for int8 pools with f32 queries (both sides
dequantize exactly; summation order). The allocator and the prefix trie
must hand out the same pages with the same refcounts as the JAX classes,
and the paged decode step match JAX's to 1e-4 in f32 (summation order
over a few layers). The CUDA kernel itself is held to these plain
versions on the card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import kvpage as jkp
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_tpu.ops import flash_decode as jfd
from mpi_acx_tpu.ops import kvquant as jkq
from mpi_acx_torch.models import kvpage as tkp
from mpi_acx_torch.models import transformer as tt
from mpi_acx_torch.ops import flash_decode as tfd

B, HKV, D, MAX_LEN, PT = 3, 2, 16, 96, 32          # max_pages = 3


def _torch(a):
    """A numpy or JAX array as a CPU tensor (bf16 through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _paged_case(kind, n_rep, W, shared, seed=0):
    """q, the fixed caches and the same rows as pools plus a shuffled
    table, as JAX arrays. kind: 'bf16' (bf16 everywhere), 'int8' (bf16 q,
    int8 code + f32 scale pools) or 'int8f32' (f32 q). ``shared`` aliases
    every slot's first page to one page (the layout of a prefix hit)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, HKV * n_rep, D))
    kc = rng.standard_normal((B, MAX_LEN, HKV, D))
    vc = rng.standard_normal((B, MAX_LEN, HKV, D))
    if shared:
        kc[:, :PT], vc[:, :PT] = kc[0, :PT], vc[0, :PT]
    max_pages = MAX_LEN // PT
    n_pool = B * max_pages + 2
    perm = rng.permutation(n_pool)[:B * max_pages]
    table = perm.reshape(B, max_pages).astype(np.int32)
    if shared:
        table[:, 0] = table[0, 0]

    def pool(c):
        p = np.zeros((n_pool, PT, HKV, D))
        p[table.reshape(-1)] = c.reshape(B * max_pages, PT, HKV, D)
        if shared:
            p[table[0, 0]] = c[0, :PT]
        return p
    qd = jnp.float32 if kind == "int8f32" else jnp.bfloat16
    q = jnp.asarray(q, qd)
    if kind == "bf16":
        return (q, *(jnp.asarray(c, jnp.bfloat16)
                     for c in (kc, vc, pool(kc), pool(vc))), table)
    quant = jax.jit(jkq.kv_quant)
    return (q, quant(jnp.asarray(kc, jnp.float32)),
            quant(jnp.asarray(vc, jnp.float32)),
            quant(jnp.asarray(pool(kc), jnp.float32)),
            quant(jnp.asarray(pool(vc), jnp.float32)), table)


def _to_t(c):
    return tuple(map(_torch, c)) if isinstance(c, tuple) else _torch(c)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("posmode", ["scalar", "vector"])
@pytest.mark.parametrize("shared", [False, True],
                         ids=["private", "aliased"])
def test_paged_gather_bit_equals_jax(kind, posmode, shared):
    """Mirrors tests/test_paged.py's anchor: the gather over pages holding
    the fixed cache's rows is bit-equal to JAX's gather, and to the port's
    dense attention on the fixed cache."""
    q, kc, vc, kp, vp, table = _paged_case(kind, 2, 1, shared)
    pos = 41 if posmode == "scalar" else np.array([33, 63, MAX_LEN - 1],
                                                  np.int32)
    want = jfd.paged_gather_attend(q, kp, vp, jnp.asarray(table),
                                   jnp.asarray(pos), PT, 2)
    got = tfd.paged_gather_attend(_torch(q), _to_t(kp), _to_t(vp),
                                  torch.from_numpy(table),
                                  torch.as_tensor(pos), PT, 2)
    dense = tfd.dense_decode_attend(_torch(q), _to_t(kc), _to_t(vc),
                                    torch.as_tensor(pos), MAX_LEN, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, 2 * HKV * D)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(got), _f32(dense))


@pytest.mark.parametrize("kind,posmode", [("bf16", "scalar"),
                                          ("int8f32", "vector")])
def test_paged_flash_matches_jax_kernel(kind, posmode):
    """B9's wrapper (its plain version on a CPU tensor) against the JAX
    paged kernel in interpret mode: GQA, a window of 2, an aliased first
    page, a shuffled table."""
    q, _, _, kp, vp, table = _paged_case(kind, 2, 2, True, seed=3)
    pos = 50 if posmode == "scalar" else np.array([0, 41, MAX_LEN - 2],
                                                  np.int32)
    want = jfd.paged_flash_decode_attend(q, kp, vp, jnp.asarray(table),
                                         jnp.asarray(pos), PT, 2)
    got = tfd.paged_flash_decode_attend(_torch(q), _to_t(kp), _to_t(vp),
                                        torch.from_numpy(table),
                                        torch.as_tensor(pos), PT, 2)
    tol = 4e-2 if kind == "bf16" else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_select_paged_switch():
    """False -> the plain version; True and None -> the kernel wrapper
    (which takes the plain version for a CPU tensor)."""
    assert tfd.select_paged_decode_attend(False) is tfd.paged_gather_attend
    assert tfd.select_paged_decode_attend(True) is \
        tfd.paged_flash_decode_attend
    assert tfd.select_paged_decode_attend(None) is \
        tfd.paged_flash_decode_attend


def test_paged_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches its kernel or raises: never a
    quiet plain-version path, in either operand form."""
    q = torch.empty((2, 1, 4, 64), device="meta")
    pool = torch.empty((5, 16, 4, 64), device="meta")
    codes = (torch.empty((5, 16, 4, 64), dtype=torch.int8, device="meta"),
             torch.empty((5, 16, 4, 1), device="meta"))
    table = torch.zeros((2, 2), dtype=torch.int32)
    for kp in (pool, codes):
        with pytest.raises(ValueError, match="no kernel"):
            tfd.paged_flash_decode_attend(q, kp, kp, table, 3, 16, 1)


# --------------------------------------------------------------------------
# allocator, trie, PagedKV


def test_allocator_and_trie_follow_jax():
    """A seeded random sequence of alloc/incref/decref and trie
    match/insert/evict operations gives the same pages, refcounts, counters
    and free counts from both packages' classes."""
    rng = np.random.default_rng(11)
    ja, ta = jkp.PageAllocator(12), tkp.PageAllocator(12)
    jtr, ttr = jkp.RadixPrefixCache(ja, 4), tkp.RadixPrefixCache(ta, 4)
    system = rng.integers(0, 5, 9)
    held = []
    for _ in range(300):
        op = rng.integers(0, 6)
        if op == 0:
            n = int(rng.integers(1, 4))
            got = (ja.alloc(n), ta.alloc(n))
            assert got[0] == got[1]
            if got[0]:
                held.extend(got[0])
        elif op == 1 and held:
            p = held.pop(int(rng.integers(0, len(held))))
            assert ja.decref(p) == ta.decref(p)
        elif op == 2 and held:
            p = held[int(rng.integers(0, len(held)))]
            ja.incref(p)
            ta.incref(p)
            held.append(p)
        elif op in (3, 4):
            prompt = np.concatenate([system[:int(rng.integers(0, 10))],
                                     rng.integers(0, 5, rng.integers(1, 9))])
            if op == 3:
                got = (jtr.match(prompt), ttr.match(prompt))
                held.extend(got[0])
            else:
                pages = ja.alloc(-(-len(prompt) // 4))
                assert ta.alloc(len(pages) if pages else 99) == pages
                if not pages:
                    continue
                held.extend(pages)
                got = (jtr.insert(prompt, pages), ttr.insert(prompt, pages))
            assert got[0] == got[1]
        elif op == 5:
            assert jtr.evict_one() == ttr.evict_one()
        assert [ja.refcount(p) for p in range(12)] == \
            [ta.refcount(p) for p in range(12)]
        assert (ja.free_count, ja.shared_count()) == (ta.free_count,
                                                      ta.shared_count())
        assert (jtr.hits, jtr.evictions, jtr.pages_reused) == (
            ttr.hits, ttr.evictions, ttr.pages_reused)
    assert ttr.hits > 0 and ttr.evictions > 0


def test_trie_caps_match_depth_like_jax():
    """A match never takes the whole prompt (the suffix keeps a token)
    and insert adopts only full pages."""
    for mod in (jkp, tkp):
        alloc = mod.PageAllocator(8)
        trie = mod.RadixPrefixCache(alloc, page_tokens=4)
        prompt = np.arange(10, dtype=np.int32)
        pages = alloc.alloc(3)
        assert trie.insert(prompt, pages) == 2
        assert alloc.refcount(pages[2]) == 1
        assert trie.match(prompt) == pages[:2]
        assert trie.match(prompt[:8]) == pages[:1]


def _cfgs(dtype="float32"):
    base = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                max_seq=96)
    jcfg = dataclasses.replace(jt.tiny_config(**base),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tt.tiny_config(**base),
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_paged_decode_step_matches_jax(models, kv_int8):
    """The same pool, table and positions (slots at their own positions,
    one idle slot on its parking page past a page edge) through three
    paged decode steps: logits within 1e-4, the rows written land on the
    same pages and offsets, pos advances like JAX's."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(12)
    n_slots, pt, max_pages, n_pages = 3, 8, 4, 9
    jpool = jkp.init_page_pool(jcfg, n_pages, pt, n_slots, kv_int8=kv_int8)
    shape = jpool["k"].shape
    if kv_int8:
        jpool["k"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        jpool["v"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        for key in ("ks", "vs"):
            jpool[key] = jnp.asarray(rng.uniform(
                0.001, 0.02, jpool[key].shape), jnp.float32)
    else:
        for key in ("k", "v"):
            jpool[key] = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    table = np.array([[2, 5, 0, 7], [1, 3, 9, 9], [11, 11, 11, 11]],
                     np.int32)
    pos = np.array([13, 7, 30], np.int32)
    jstate = dict(jpool, table=jnp.asarray(table), pos=jnp.asarray(pos))
    tstate = {k: _torch(v) for k, v in jstate.items()}
    step = jax.jit(lambda s, t: jkp.paged_decode_step(jparams, jcfg, s, t,
                                                      pt))
    for i in range(3):
        tok = rng.integers(0, 61, n_slots).astype(np.int32)
        jl, jstate = step(jstate, jnp.asarray(tok))
        tl, tstate = tkp.paged_decode_step(tparams, tcfg, tstate,
                                           torch.from_numpy(tok), pt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(tstate["pos"].numpy(), pos + 3)
    for key in jpool:
        got, want = tstate[key].numpy(), np.asarray(jstate[key])
        if key in ("k", "v") and kv_int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert tstate["k"].shape == (2, n_pages + n_slots, pt, 4, 12)


def test_prefill_with_history_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(13)
    hk = rng.standard_normal((2, 16, 4, 12)).astype(np.float32)
    hv = rng.standard_normal((2, 16, 4, 12)).astype(np.float32)
    suffix = rng.integers(0, 61, (1, 8)).astype(np.int32)
    jl, jk, jv = jkp.prefill_with_history(jparams, jcfg, jnp.asarray(suffix),
                                          jnp.asarray(hk), jnp.asarray(hv), 5)
    tl, tk, tv = tkp.prefill_with_history(tparams, tcfg,
                                          torch.from_numpy(suffix),
                                          torch.from_numpy(hk),
                                          torch.from_numpy(hv), 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert tuple(tk.shape) == jk.shape == (2, 1, 8, 4, 12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_paged_kv_scatter_gather_cow_match_jax(models, kv_int8):
    """PagedKV's prompt scatter, history gather (dequantized), copy on
    write and release on both packages from the same prefilled cache."""
    jcfg, jparams, tcfg, tparams = models
    tok = np.random.default_rng(14).integers(0, 61, (1, 16)).astype(np.int32)
    _, jone = jt.prefill(jparams, jcfg, jnp.asarray(tok), 16,
                         kv_int8=kv_int8)
    _, tone = tt.prefill(tparams, tcfg, torch.from_numpy(tok), 16,
                         kv_int8=kv_int8)
    jone.pop("pos")
    tone.pop("pos")
    if kv_int8:      # the same codes on both sides
        tone = {k: _torch(v) for k, v in jone.items()}
    jkv = jkp.PagedKV(jcfg, jt, 2, 32, 8, 6, kv_int8=kv_int8)
    tkv = tkp.PagedKV(tcfg, tt, 2, 32, 8, 6, kv_int8=kv_int8, device="cpu")
    for kv in (jkv, tkv):
        pages = kv.alloc_evicting(3)
        kv.seat(0, [], pages[:2], new_pos=16)
        kv.alloc.incref(pages[0])                 # a second owner
        kv.scatter_prompt(jone if kv is jkv else tone, pages[:2])
    for key in jkv.pool:
        np.testing.assert_allclose(tkv.pool[key].numpy(),
                                   np.asarray(jkv.pool[key]), atol=1e-6)
    jh, th = jkv.gather_history([1, 0]), tkv.gather_history([1, 0])
    for a, b in zip(jh, th):
        assert tuple(b.shape) == a.shape == (2, 16, 4, 12)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    assert jkv.ensure_writable(0, 0) and tkv.ensure_writable(0, 0)
    assert tkv.pages == jkv.pages and (tkv.table == jkv.table).all()
    new = tkv.pages[0][0]
    np.testing.assert_array_equal(tkv.pool["k"][:, new].numpy(),
                                  tkv.pool["k"][:, 0].numpy())
    assert not tkv.ensure_writable(0, 0)
    for kv in (jkv, tkv):
        kv.release(0)
    assert (tkv.table == jkv.table).all() and (tkv.table[0] == 6).all()
    assert tkv.alloc.used_count == jkv.alloc.used_count == 2


def test_paged_kv_device_mirrors_and_reset():
    """The table and positions reach the device only after the host
    changed them; absorb advances the host positions without a read-back;
    reset_pool zeroes the pool and drops every reference."""
    _, tcfg = _cfgs()
    kv = tkp.PagedKV(tcfg, tt, 2, 32, 8, 6, prefix_cache=True, device="cpu")
    s1 = kv.device_state()
    assert kv.device_state()["table"] is s1["table"]
    kv.seat(1, [], kv.alloc_evicting(2), new_pos=9)
    s2 = kv.device_state()
    assert s2["table"] is not s1["table"] and int(s2["pos"][1]) == 9
    kv.absorb(dict(s2, pos=s2["pos"] + 4), 4)
    assert list(kv.pos) == [4, 13] and kv.device_state()["pos"] is not None
    kv.pool["k"].fill_(1.0)
    kv.prefix.hits = 3
    kv.reset_pool()
    assert not kv.pool["k"].any() and kv.alloc.used_count == 0
    assert kv.prefix.hits == 3 and kv.pages == [[], []]
    assert tkp.default_page_tokens(96) == 96 and tkp.pages_needed(17, 8) == 3


def test_default_page_tokens_reads_the_jax_knob(monkeypatch):
    monkeypatch.setenv("ACX_KV_PAGE_TOKENS", "48")
    for n in (96, 100, 1024):
        assert tkp.default_page_tokens(n) == jkp.default_page_tokens(n)
    monkeypatch.delenv("ACX_KV_PAGE_TOKENS")
    assert tkp.default_page_tokens(1024) == jkp.default_page_tokens(1024) \
        == 128


def test_publish_page_stats_never_loads_the_library(monkeypatch):
    from mpi_acx_torch import runtime
    monkeypatch.setattr(runtime, "_lib", None)
    assert tkp.publish_page_stats_best_effort(1, 2, 3, 4, 5) is False
    assert runtime._lib is None


@pytest.fixture(scope="module")
def moe_models():
    """The tiny MoE transformer (drop-free), drawn by the port and carried
    to JAX as numpy."""
    from mpi_acx_tpu.models import moe_transformer as jmt
    from mpi_acx_torch.models import moe_transformer as tmt
    base = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                n_experts=4, top_k=2, capacity_factor=4.0, max_seq=96)
    jcfg = dataclasses.replace(jmt.tiny_moe_config(**base), dtype=jnp.float32)
    tcfg = dataclasses.replace(tmt.tiny_moe_config(**base),
                               dtype=torch.float32)
    tparams = tmt.init_params(tcfg, seed=4, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, jparams, jmt._moe_ffn, tcfg, tparams, tmt._moe_ffn


def _no_ffn(cfg, lp, x):
    return x


@pytest.mark.parametrize("entry", ["paged_decode_step",
                                   "prefill_with_history"])
def test_ffn_hook_runs_the_moe_ffn_like_jax(moe_models, entry):
    """The ``ffn=`` hook of both paged entries with the routed MoE FFN:
    logits (and the suffix K/V) within 1e-4 of JAX's with its MoE FFN,
    and apart from those of a hook that skips the FFN."""
    jcfg, jparams, jffn, tcfg, tparams, tffn = moe_models
    rng = np.random.default_rng(14)
    if entry == "paged_decode_step":
        pt, n_slots = 8, 3
        jpool = jkp.init_page_pool(jcfg, 9, pt, n_slots)
        for key in ("k", "v"):
            jpool[key] = jnp.asarray(rng.standard_normal(jpool[key].shape),
                                     jnp.float32)
        table = np.array([[2, 5, 0, 7], [1, 3, 4, 6], [11, 11, 11, 11]],
                         np.int32)
        jstate = dict(jpool, table=jnp.asarray(table),
                      pos=jnp.asarray(np.array([13, 7, 30], np.int32)))
        tok = rng.integers(0, 61, n_slots).astype(np.int32)

        def tcall(ffn):
            tstate = {k: _torch(v) for k, v in jstate.items()}
            return tkp.paged_decode_step(tparams, tcfg, tstate,
                                         torch.from_numpy(tok), pt,
                                         ffn=ffn)[0]
        jl, _ = jkp.paged_decode_step(jparams, jcfg, jstate,
                                      jnp.asarray(tok), pt, ffn=jffn)
        tl, skipped = tcall(tffn), tcall(_no_ffn)
    else:
        hk, hv = (rng.standard_normal((2, 16, 4, 12)).astype(np.float32)
                  for _ in range(2))
        suffix = rng.integers(0, 61, (1, 8)).astype(np.int32)
        jl, jk, _ = jkp.prefill_with_history(
            jparams, jcfg, jnp.asarray(suffix), jnp.asarray(hk),
            jnp.asarray(hv), 5, ffn=jffn)
        args = (tparams, tcfg, torch.from_numpy(suffix),
                torch.from_numpy(hk), torch.from_numpy(hv), 5)
        tl, tk, _ = tkp.prefill_with_history(*args, ffn=tffn)
        skipped = tkp.prefill_with_history(*args, ffn=_no_ffn)[0]
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert not np.allclose(skipped.numpy(), tl.numpy(), atol=1e-3)
