"""The attention wrappers' rules at Llama-3-8B's head dim (128) beside
GPT-2's (64), on the CPU: K1's CTA-size rule at 32 heads, the decode
kernels' split rule and row blocks at 8 KV groups of 4 query heads, and
what each wrapper refuses before it would launch, naming what is refused.

A tensor that is not on the CPU goes to the kernel; the checks before the
launch run on meta tensors here (no card needed). On a CPU tensor every
head dim runs the plain version.
"""

import math

import pytest
import torch

from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.ops import flash_decode as tfd

H100_SMS = 132


# (B, S, H, rows): 64 rows while B * H * ceil(S / 64) <= 132.
@pytest.mark.parametrize("B,S,H,want", [
    (1, 32, 32, 64), (1, 128, 32, 64), (1, 256, 32, 64),     # 32-128 CTAs
    (1, 257, 32, 128), (1, 512, 32, 128), (1, 1000, 32, 128),
    (2, 128, 32, 64), (2, 129, 32, 128),                      # 128 and 192
    (1, 704, 12, 64), (1, 768, 12, 128)])                     # GPT-2's edge
def test_block_rows_at_32_heads(B, S, H, want):
    assert tattn.block_rows(B, S, H, H100_SMS) == want
    assert (want == 64) == (B * H * math.ceil(S / 64) <= H100_SMS)


@pytest.mark.parametrize("W,n_rep,want", [(1, 4, 4), (2, 4, 8), (3, 4, 8),
                                          (1, 1, 1)])
def test_row_block_at_llama_groups(W, n_rep, want):
    """A served Llama step's 4 query heads of a group are one row block."""
    assert tfd.row_block(W * n_rep) == want


# (B, Hkv, rows, max_len, head dim, chunk the rule picks)
SPLIT_CASES = [
    ("llama served", 8, 8, 4, 1024, 128, 256),
    ("llama same shape at D=64", 8, 8, 4, 1024, 64, 128),
    ("llama W*n_rep 8", 8, 8, 8, 1024, 128, 256),
    ("llama W*n_rep 12", 8, 8, 12, 1024, 128, 512),
    ("llama max_len 1000", 8, 8, 4, 1000, 128, 256),
    ("llama one slot", 1, 8, 4, 1024, 128, 128),
    ("llama 8K cache", 8, 8, 4, 8192, 128, 2048),
    ("gpt2 served", 8, 12, 1, 1024, 64, 256),
]


@pytest.mark.parametrize("label,B,Hkv,rows,max_len,D,want", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_decode_chunk_by_head_dim(label, B, Hkv, rows, max_len, D, want):
    """At D = 128 a full cache is given half as many CTAs an SM as at
    D = 64 (a CTA's tile bytes double); the chunk is the smallest whole
    number of tiles within that and one cluster."""
    chunk = tfd.decode_chunk(B, Hkv, rows, max_len, H100_SMS, D)
    assert chunk == want
    assert chunk % tfd.TILE == 0
    per_sm = tfd.CTAS_PER_SM * 64 // D
    units = B * Hkv * math.ceil(rows / tfd.row_block(rows))
    per_slot = min(tfd.MAX_CLUSTER, max(1, per_sm * H100_SMS // units))
    assert math.ceil(max_len / chunk) <= per_slot
    if chunk > tfd.TILE:
        assert math.ceil(max_len / (chunk - tfd.TILE)) > per_slot


def test_decode_chunk_defaults_to_head_dim_64():
    assert tfd.decode_chunk(8, 12, 1, 1024, H100_SMS) == \
        tfd.decode_chunk(8, 12, 1, 1024, H100_SMS, 64)


def _meta(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("D", [32, 96, 256])
def test_k1_refuses_other_head_dims(D):
    q = _meta(1, 8, 2, D)
    with pytest.raises(ValueError, match=r"head dims 64, 128, got %d" % D):
        tattn.flash_attention(q, q, q)


@pytest.mark.parametrize("D", [64, 128])
def test_k1_takes_64_and_128(D):
    """Past the head-dim check, a meta tensor stops at the device check."""
    q = _meta(1, 8, 2, D)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tattn.flash_attention(q, q, q)


def test_b10_refuses_head_dim_128():
    """B10 takes head dims 64 and 128 (past the head-dim check a meta
    tensor stops at the device check) and refuses any other by name."""
    for D in (64, 128):
        q = _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match="no kernel for meta"):
            tattn.flash_attention_lse(q, q, q)
    for D in (32, 96, 256):
        q = _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match=r"flash_attention_lse: the "
                           r"kernel is built for head dims 64, 128, got "
                           r"%d" % D):
            tattn.flash_attention_lse(q, q, q)


def test_b7_refuses_head_dim_128():
    """The streaming entry (B7) takes head dims 64 and 128 and refuses any
    other by name."""
    for D in (64, 128):
        q = _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match="no kernel for meta"):
            tattn.flash_attention(q, q, q, streaming=True)
    for D in (32, 96, 256):
        q = _meta(1, 8, 2, D)
        with pytest.raises(ValueError, match=r"streaming=True\): the "
                           r"kernel is built for head dims 64, 128, got "
                           r"%d" % D):
            tattn.flash_attention(q, q, q, streaming=True)


@pytest.mark.parametrize("D", [32, 96, 256])
def test_k2_refuses_other_head_dims(D):
    q = _meta(2, 1, 8, D)
    kc = _meta(2, 128, 2, D)
    with pytest.raises(ValueError, match=r"flash_decode_attend: the kernel "
                       r"is built for head dims 64, 128, got %d" % D):
        tfd.flash_decode_attend(q, kc, kc, 0, 128, 4)


@pytest.mark.parametrize("D", [64, 128])
def test_k2_takes_64_and_128(D):
    q = _meta(2, 1, 8, D)
    kc = _meta(2, 128, 2, D)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tfd.flash_decode_attend(q, kc, kc, 0, 128, 4)


def test_b9_refuses_head_dim_128():
    q = _meta(2, 1, 8, 128)
    pool = _meta(4, 16, 2, 128)
    table = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"paged_flash_decode_attend: head "
                       r"dim 128 is built for the contiguous cache"):
        tfd.paged_flash_decode_attend(q, pool, pool, table, 0, 16, 4)
    with pytest.raises(ValueError, match="built for head dims 64, got 96"):
        tfd.paged_flash_decode_attend(_meta(2, 1, 8, 96), pool, pool, table,
                                      0, 16, 4)


def test_cpu_tensors_run_the_plain_versions_at_128():
    """Every head dim runs on the CPU, through the plain versions, and no
    launch is counted."""
    names = ("launches", "launches_d128", "launches_stream",
             "launches_stream_d128")
    lse_names = ("launches", "launches_d128")
    for n in names:
        setattr(tattn.flash_attention, n, 0)
    for n in lse_names:
        setattr(tattn.flash_attention_lse, n, 0)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, 2, 128, generator=g) for _ in range(3))
    torch.testing.assert_close(tattn.flash_attention(q, k, v),
                               tattn.attention_reference(q, k, v))
    o, lse = tattn.flash_attention_lse(q, k, v)
    torch.testing.assert_close(o, tattn.attention_reference(q, k, v))
    assert lse.shape == (1, 2, 9)
    tattn.flash_attention(q, k, v, streaming=True)
    qd = torch.randn(2, 1, 8, 128, generator=g)
    kc = torch.randn(2, 16, 2, 128, generator=g)
    out = tfd.flash_decode_attend(qd, kc, kc, 5, 16, 4)
    torch.testing.assert_close(out, tfd.dense_decode_attend(qd, kc, kc, 5,
                                                            16, 4))
    assert all(getattr(tattn.flash_attention, n) == 0 for n in names)
    assert all(getattr(tattn.flash_attention_lse, n) == 0
               for n in lse_names)
    assert tfd.flash_decode_attend.launches_d128 == 0
    assert tfd.flash_decode_attend.launches_int8_d128 == 0
