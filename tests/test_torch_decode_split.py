"""The decode kernels' split of each slot's keys over CTAs
(mpi_acx_torch/ops/flash_decode.py, csrc/flash_decode.cu), held where it
can be held without the card.

The kernel itself runs only on the card (chip_smoke.py holds it against
the plain versions there). Here: the split rule ``decode_chunk`` on its
observable inputs alone (never ``pos``), and a PyTorch re-enactment of
what the kernel computes with that plan: per (slot, KV group, block of
window rows) the live chunks' partial states ``(m, l, acc)``, merged in
chunk order. In f32 the re-enactment must match the JAX package's Pallas
decode kernels (interpret mode, as tests/test_torch_ops.py runs them) to
1e-5, the bound of summation order; and its paged run must equal its
contiguous run bit for bit, since chunk boundaries are positions, not
pages.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.ops import flash_decode as jfd
from mpi_acx_torch.ops import flash_decode as tfd

TOL = 1e-5
H100_SMS = 132

# (label, B, Hkv, rows = W * n_rep, max_len, sm_count, chunk the rule picks)
RULE_CASES = [
    ("served", 8, 12, 1, 1024, H100_SMS, 256),
    ("full cache", 8, 12, 1, 1024, H100_SMS, 256),
    ("W*n_rep 8", 8, 6, 8, 1024, H100_SMS, 128),
    ("W*n_rep 12", 8, 4, 12, 1024, H100_SMS, 128),
    ("max_len 1000", 8, 12, 1, 1000, H100_SMS, 256),
    ("fewer SMs", 8, 12, 1, 1024, 46, 1024),
    ("one slot", 1, 12, 1, 1024, H100_SMS, 128),
    ("long cache", 8, 8, 1, 8192, H100_SMS, 1024),
    ("many slots", 64, 32, 1, 8192, H100_SMS, 8192),
]


def test_split_rule_reads_no_positions():
    """The grid is sized on the host: the rule sees the shape (head dim
    included) and the card, never the positions (they live on the
    card)."""
    params = list(inspect.signature(tfd.decode_chunk).parameters)
    assert params == ["B", "Hkv", "rows", "max_len", "sm_count", "head_dim"]
    assert not any("pos" in p for p in params)


@pytest.mark.parametrize("label,B,Hkv,rows,max_len,sms,want", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_split_rule(label, B, Hkv, rows, max_len, sms, want):
    """A whole number of tiles; a slot's chunks fit one cluster, and a
    full cache needs no more CTAs than the card holds at once; one tile
    less per chunk would break one of the two (the rule takes the smallest
    such chunk)."""
    chunk = tfd.decode_chunk(B, Hkv, rows, max_len, sms)
    assert chunk == want
    assert chunk % tfd.TILE == 0 and chunk >= tfd.TILE
    units = B * Hkv * math.ceil(rows / tfd.row_block(rows))
    per_slot = min(tfd.MAX_CLUSTER,
                   max(1, tfd.CTAS_PER_SM * sms // units))
    assert math.ceil(max_len / chunk) <= per_slot
    if chunk > tfd.TILE:
        assert math.ceil(max_len / (chunk - tfd.TILE)) > per_slot


@pytest.mark.parametrize("rows,want", [(1, 1), (2, 2), (3, 4), (4, 4),
                                       (5, 8), (8, 8), (12, 8)])
def test_row_block(rows, want):
    assert tfd.row_block(rows) == want


# --------------------------------------------------------------------------
# the chunk plan and the ordered merge, re-enacted

B, HKV, D, MAX_LEN, PT = 5, 2, 16, 512, 32


def reenact(q, rows_of, pos, max_len, n_rep, chunk):
    """What the kernel computes, in PyTorch f32: q [B, W, Hq, D]; the K/V
    rows [t0, t1) of slot b's group g come from ``rows_of(b, g, t0, t1)``.
    Each (slot, row block, group) splits its live keys into chunks of
    ``chunk`` positions; each chunk leaves (m, l, acc), and a slot with
    more than one live chunk merges them in chunk order, as an online
    softmax over the partials (the kernel's merge)."""
    Bq, W, Hq, Dq = q.shape
    Wn, Hkv = W * n_rep, Hq // n_rep
    R = tfd.row_block(Wn)
    out = torch.zeros(Bq, W, Hq, Dq)
    for b in range(Bq):
        p0 = int(pos[b])
        for i0 in range(0, Wn, R):
            rws = list(range(i0, min(i0 + R, Wn)))
            live = min(p0 + rws[-1] // n_rep + 1, max_len)
            horizon = torch.tensor([p0 + r // n_rep for r in rws])
            for g in range(Hkv):
                qr = torch.stack([q[b, r // n_rep, g * n_rep + r % n_rep]
                                  for r in rws]) * (1.0 / Dq ** 0.5)
                parts = []
                for c0 in range(0, live, chunk):
                    c1 = min(c0 + chunk, live)
                    k, v = rows_of(b, g, c0, c1)
                    s = qr @ k.T
                    vis = torch.arange(c0, c1)[None, :] <= horizon[:, None]
                    s = torch.where(vis, s, torch.tensor(-1e30))
                    m = s.max(-1).values
                    p = torch.where(vis, torch.exp(s - m[:, None]),
                                    torch.tensor(0.0))
                    parts.append((m, p.sum(-1), p @ v))
                M, L, A = parts[0]
                for m, l_c, acc in parts[1:]:          # chunk order
                    m_new = torch.maximum(M, m)
                    f_old, f = torch.exp(M - m_new), torch.exp(m - m_new)
                    L = l_c * f + L * f_old
                    A = acc * f[:, None] + A * f_old[:, None]
                    M = m_new
                o = A / L[:, None]
                for n, r in enumerate(rws):
                    out[b, r // n_rep, g * n_rep + r % n_rep] = o[n]
    return out.reshape(Bq, W, Hq * Dq)


def _case(n_rep, W, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, HKV * n_rep, D), dtype=np.float32)
    kc = rng.standard_normal((B, MAX_LEN, HKV, D), dtype=np.float32)
    vc = rng.standard_normal((B, MAX_LEN, HKV, D), dtype=np.float32)
    return q, kc, vc


def _pages(kc, vc, seed):
    """The caches' rows as shuffled pools of PT-token pages, slot b's page
    j at pool page table[b, j]."""
    max_pages = MAX_LEN // PT
    perm = np.random.default_rng(seed).permutation(B * max_pages + 2)
    table = perm[:B * max_pages].reshape(B, max_pages).astype(np.int32)
    shape = (B * max_pages + 2, PT, HKV, D)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kp[table.reshape(-1)] = kc.reshape(B * max_pages, PT, HKV, D)
    vp[table.reshape(-1)] = vc.reshape(B * max_pages, PT, HKV, D)
    return kp, vp, table


def _contiguous(kc, vc):
    k, v = torch.from_numpy(kc), torch.from_numpy(vc)
    return lambda b, g, t0, t1: (k[b, t0:t1, g].contiguous(),
                                 v[b, t0:t1, g].contiguous())


def _paged(kp, vp, table):
    k, v, tab = torch.from_numpy(kp), torch.from_numpy(vp), \
        torch.from_numpy(table).long()

    def rows_of(b, g, t0, t1):
        t = torch.arange(t0, t1)
        u, r = tab[b, t // PT], t % PT
        return k[u, r, g].contiguous(), v[u, r, g].contiguous()
    return rows_of


def _edges(chunk, W):
    """Slot positions at the chunk edges: 0, c - 1, c, 2c - 1 and the
    last row max_len - W."""
    return np.array([0, chunk - 1, chunk, 2 * chunk - 1, MAX_LEN - W],
                    np.int32)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("W,n_rep", [(1, 1), (3, 2), (4, 3)])
def test_reenactment_matches_jax_kernels(W, n_rep, chunk):
    """The plan and the ordered merge against the JAX decode kernel and
    its paged sibling (interpret mode), at positions on the chunk edges
    (W * n_rep of 1, 6 and 12: one row block and two); the paged run
    equals the contiguous one bit for bit."""
    q, kc, vc = _case(n_rep, W, seed=W * 10 + n_rep)
    pos = _edges(chunk, W)
    kp, vp, table = _pages(kc, vc, seed=chunk)
    qt = torch.from_numpy(q)
    got = reenact(qt, _contiguous(kc, vc), pos, MAX_LEN, n_rep, chunk)
    got_paged = reenact(qt, _paged(kp, vp, table), pos, MAX_LEN, n_rep,
                        chunk)
    assert torch.equal(got.view(torch.int32), got_paged.view(torch.int32))
    want = jfd.flash_decode_attend(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos),
                                   MAX_LEN, n_rep, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    want_paged = jfd.paged_flash_decode_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), PT, n_rep)
    np.testing.assert_allclose(got_paged.numpy(), np.asarray(want_paged),
                               atol=TOL, rtol=TOL)


def test_reenactment_one_chunk_is_the_whole_slot():
    """With one chunk per slot (the rule's chunk at the cache length) the
    merge is the identity: the re-enactment equals the plain version on
    the same inputs to summation order."""
    q, kc, vc = _case(2, 2, seed=9)
    pos = np.array([0, 5, 63, 64, MAX_LEN - 2], np.int32)
    got = reenact(torch.from_numpy(q), _contiguous(kc, vc), pos, MAX_LEN,
                  2, MAX_LEN)
    want = tfd.dense_decode_attend(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc),
                                   torch.from_numpy(pos), MAX_LEN, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)
