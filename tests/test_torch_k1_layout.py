"""K1's host-side rules (mpi_acx_torch/ops/attention.py) on CPU tensors.

The kernel runs only on the card (chip_smoke.py holds it against its plain
version there); what the wrapper decides before a launch is plain Python
and is checked here: the CTA-size rule (64 or 128 query rows per CTA, from
the shape and the card's SM count) and the TMA layout rule (which bf16 operands the tensor
maps read in place, which the wrapper copies first). The layout rule is
held on the operands the port's own call sites produce, recorded at GPT-2
124M's widths (d_model 768, 12 heads of 64) with depth and vocabulary cut.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.parallel import ring_attention as tring
from mpi_acx_torch.parallel.mesh import mesh_from_devices

H, D = 12, 64
GPT2_CUT = dataclasses.replace(tfm.gpt2_small(), vocab=64, n_layers=1,
                               max_seq=64)


@pytest.mark.parametrize("B,S,sms,rows", [
    (1, 32, 132, 64), (1, 128, 132, 64), (1, 256, 132, 64),
    (1, 512, 132, 64),                   # serving prefill: 96 CTAs of 64
    (1, 704, 132, 64),                   # 12 x 11 = 132: one wave of 64
    (1, 705, 132, 128),                  # 12 x 12 = 144: a second wave
    (1, 1024, 132, 128),
    (4, 64, 132, 64),                    # 4 x 12 x 1 = 48
    (4, 129, 132, 128),                  # 4 x 12 x 3 = 144
    (4, 1024, 132, 128),                 # B10 in training
    (1, 16384, 132, 128),                # B7, long context
    (1, 640, 114, 128),                  # 120 CTAs on a card of 114 SMs
    (1, 576, 114, 64),                   # 108 CTAs on it
])
def test_block_rows_rule(B, S, sms, rows):
    assert tattn.block_rows(B, S, H, sms) == rows


def _record_prefill(monkeypatch, B, S):
    """q, k, v that the model's prefill attention hands K1 (through
    ``select_attention``), for each layer."""
    calls = []

    def select(use_flash):
        def attend(q, k, v, causal=True):
            calls.append((q, k, v))
            return tattn.attention_reference(q, k, v, causal=causal)
        return attend

    monkeypatch.setattr(tfm, "select_attention", select)
    params = tfm.cast_params(tfm.init_params(
        dataclasses.replace(GPT2_CUT, dtype=torch.float32), seed=0,
        device="cpu"), torch.bfloat16)
    tokens = torch.from_numpy(
        np.random.default_rng(B).integers(0, GPT2_CUT.vocab, (B, S)))
    tfm.forward(params, GPT2_CUT, tokens)
    return calls


def _record_ring(monkeypatch):
    """Record the operands of every B10 call the ring makes."""
    calls = []
    real = tattn.flash_attention_lse

    def lse(q, k, v, causal=True):
        calls.append((q, k, v))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tring, "flash_attention_lse", lse)
    return calls


def _ring_kv_repeat(monkeypatch, kv_repeat):
    """Ring attention's flash block_fn with grouped K/V heads, the
    operands cut from one fused projection as the attention half does."""
    calls = _record_ring(monkeypatch)
    mb, blk, hkv = 2, 16, H // kv_repeat
    g = torch.Generator().manual_seed(kv_repeat)
    qkv = torch.randn((mb, blk, (H + 2 * hkv) * D), generator=g).to(
        torch.bfloat16)
    q, k, v = qkv.split([H * D, hkv * D, hkv * D], dim=-1)
    with mesh_from_devices({"x": 1}):
        tring.ring_attention_batched(
            q.reshape(mb, blk, H, D), k.reshape(mb, blk, hkv, D),
            v.reshape(mb, blk, hkv, D), "x", use_flash=True,
            kv_repeat=kv_repeat)
    return calls


def _pipeline_microbatches(monkeypatch):
    """The train step's attention on the pipeline's microbatch slices
    (2 microbatches of 2 x 16 tokens, ring blocks through B10)."""
    calls = _record_ring(monkeypatch)
    cfg = dataclasses.replace(GPT2_CUT, use_flash=True)
    params = tfm.stage_slice(tfm.init_params(
        dataclasses.replace(cfg, dtype=torch.float32), seed=1,
        device="cpu"), 1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 2, 16)).astype(np.int32)
    grad_fn, _ = ttrain.make_loss_and_grads(
        cfg, mesh_from_devices({"dp": 1, "pp": 1, "tp": 1}), 2,
        device="cpu")
    grad_fn(params, tokens, np.roll(tokens, -1, axis=-1))
    return calls


SITES = {
    "qkv_B1": lambda mp: _record_prefill(mp, 1, 24),
    "qkv_B4": lambda mp: _record_prefill(mp, 4, 24),
    "ring_kv_repeat1": lambda mp: _ring_kv_repeat(mp, 1),
    "ring_kv_repeat2": lambda mp: _ring_kv_repeat(mp, 2),
    "pipeline_microbatches": _pipeline_microbatches,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_call_site_operands_are_tma_ready(monkeypatch, site):
    """Every q, k, v that a call site of the port hands K1 is read in
    place by the tensor maps: no copy on the served or trained paths."""
    calls = SITES[site](monkeypatch)
    assert calls, f"{site} reached no attention call"
    for ops in calls:
        for x in ops:
            assert x.dtype == torch.bfloat16 and x.shape[-2:] == (H, D)
            assert x.stride(-1) == 1 and x.stride(-2) == D
            assert tattn.tma_ready(x), (site, tuple(x.stride()),
                                        x.data_ptr() % 16)


def _offset(x, elems):
    """``x``'s values in a buffer starting ``elems`` elements in."""
    buf = torch.zeros(x.numel() + elems, dtype=x.dtype)
    y = buf[elems:].view(x.shape)
    y.copy_(x)
    return y


def _seq_stride(x, extra):
    """``x`` as a view whose seq stride is H*D + ``extra`` elements."""
    B, S = x.shape[:2]
    buf = torch.zeros((B, S, H * D + extra), dtype=x.dtype)
    y = buf[..., :H * D].view(B, S, H, D)
    y.copy_(x)
    return y


@pytest.mark.parametrize("case,ready", [
    ("contiguous", True),
    ("offset_8_elements", True),          # 16 bytes: still aligned
    ("offset_1_element", False),          # 2 bytes: an odd offset
    ("offset_3_elements", False),
    ("seq_stride_plus_8", True),          # 16 more bytes a row
    ("seq_stride_plus_4", False),         # 8 bytes: not a 16-byte multiple
    ("seq_stride_plus_1", False),
    ("batch_of_one_any_batch_stride", True),
    ("broadcast_seq", False),             # seq stride 0
])
def test_tma_layout_rule(case, ready):
    g = torch.Generator().manual_seed(0)
    base = torch.randn((2, 8, H, D), generator=g).to(torch.bfloat16)
    x = {
        "contiguous": lambda: base,
        "offset_8_elements": lambda: _offset(base, 8),
        "offset_1_element": lambda: _offset(base, 1),
        "offset_3_elements": lambda: _offset(base, 3),
        "seq_stride_plus_8": lambda: _seq_stride(base, 8),
        "seq_stride_plus_4": lambda: _seq_stride(base, 4),
        "seq_stride_plus_1": lambda: _seq_stride(base, 1),
        "batch_of_one_any_batch_stride": lambda: torch.empty_strided(
            (1, 8, H, D), (7, H * D, D, 1), dtype=torch.bfloat16),
        "broadcast_seq": lambda: base[:, :1].expand(2, 8, H, D),
    }[case]()
    assert tattn.tma_ready(x) is ready


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 8, H, D), (8 * H * D, H * D), (8 * H * D, H * D)),
    ((1, 8, H, D), (12345, 3 * H * D), (8 * 3 * H * D, 3 * H * D)),
    ((2, 1, H, D), (5 * H * D, 7), (5 * H * D, H * D)),
    ((1, 1, H, D), (3, 7), (H * D, H * D)),
])
def test_tma_strides_of_size_one_dims(shape, strides, want):
    """A dimension of size 1 never moves the index, so K1 takes the
    stride a contiguous layout would give it."""
    x = torch.empty_strided(shape, strides + (D, 1), dtype=torch.bfloat16)
    assert tattn.tma_strides(x) == want


def test_cpu_tensors_copy_nothing():
    """On CPU tensors the plain version runs: no operand is copied for a
    kernel, however it is laid out."""
    tattn.flash_attention.copies = 0
    g = torch.Generator().manual_seed(2)
    q, k, v = (_offset(torch.randn((1, 8, H, D), generator=g).to(
        torch.bfloat16), 1) for _ in range(3))
    tattn.flash_attention(q, k, v)
    tattn.flash_attention_lse(q, k, v)
    assert tattn.flash_attention.copies == 0
