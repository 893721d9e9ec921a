"""The KV handoff's wire layout (mpi_acx_torch/parallel/kv_ship.py) against
the JAX package's (mpi_acx_tpu/parallel/kv_ship.py): the packed bytes, the
tags and the partition size are one contract, so ranks of the two packages
meet on one wire (docs/MIGRATION.md, "KV-handoff partition layout")."""

import numpy as np
import pytest
import torch

from mpi_acx_tpu.parallel import kv_ship as jks
from mpi_acx_torch.parallel import kv_ship as tks


def _layer(seed, bucket, heads, head_dim):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, (bucket, heads, head_dim)).astype(np.int8)
    vq = rng.integers(-127, 128, (bucket, heads, head_dim)).astype(np.int8)
    ks = rng.random((bucket, heads, 1)).astype(np.float32)
    vs = rng.random((bucket, heads, 1)).astype(np.float32)
    return kq, ks, vq, vs


@pytest.mark.parametrize("bucket,heads,head_dim", [(8, 2, 4), (16, 4, 32),
                                                   (64, 12, 64)])
def test_pack_gives_jax_bytes(bucket, heads, head_dim):
    """Numpy arrays and CPU tensors pack to JAX's bytes; unpack inverts."""
    kq, ks, vq, vs = _layer(bucket, bucket, heads, head_dim)
    n = jks.layer_part_bytes(bucket, heads, head_dim)
    assert tks.layer_part_bytes(bucket, heads, head_dim) == n
    want = np.zeros(n, np.uint8)
    jks.pack_layer(want, kq, ks, vq, vs)
    for args in ((kq, ks, vq, vs),
                 tuple(torch.from_numpy(a) for a in (kq, ks, vq, vs))):
        row = np.full(n, 0xAB, np.uint8)
        tks.pack_layer(row, *args)
        np.testing.assert_array_equal(row, want)
    for got, ref in zip(tks.unpack_layer(want, bucket, heads, head_dim),
                        (kq, ks, vq, vs)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_gpt2_partition_size():
    """1632 B a token a layer at GPT-2's 12 heads x 64; 12 layers at
    bucket 512 make a 10.03 MB handoff."""
    assert tks.layer_part_bytes(1, 12, 64) == 1632
    assert 12 * tks.layer_part_bytes(512, 12, 64) == 10_027_008


def test_tags_equal_jax():
    assert (tks.KV_TAG_BASE, tks.DESC_HDR_TAG, tks.DESC_FIN_TAG) == \
        (jks.KV_TAG_BASE, jks.DESC_HDR_TAG, jks.DESC_FIN_TAG)
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):
        assert tks.kv_tag(b) == jks.kv_tag(b)
    with pytest.raises(ValueError, match="power of two"):
        tks.kv_tag(48)
    geom = tks.ChannelGeom(1, 64, 12, 12, 64)
    assert geom.part_bytes == jks.ChannelGeom(1, 64, 12, 12, 64).part_bytes


@pytest.mark.parametrize("bad", ["k_bf16", "k_f32", "s_bf16"])
def test_unquantized_layers_are_refused(bad):
    """The wire rule: codes int8, scales f32, or the pack refuses; the
    shipper quantizes first, never the wire."""
    kq, ks, vq, vs = (torch.from_numpy(a) for a in _layer(0, 8, 2, 4))
    if bad == "k_bf16":
        kq = kq.to(torch.bfloat16)
    elif bad == "k_f32":
        kq = kq.float()
    else:
        vs = vs.to(torch.bfloat16)
    row = np.zeros(tks.layer_part_bytes(8, 2, 4), np.uint8)
    with pytest.raises((AssertionError, TypeError)):
        tks.pack_layer(row, kq, ks, vq, vs)


def test_codes_on_the_card_are_refused():
    """A tensor that is not on the host is refused by name (the shipper
    copies each layer's codes to the host before packing)."""
    kq, ks, vq, vs = (torch.from_numpy(a) for a in _layer(0, 8, 2, 4))
    row = np.zeros(tks.layer_part_bytes(8, 2, 4), np.uint8)
    with pytest.raises(TypeError, match="host"):
        tks.pack_layer(row, kq.to("meta"), ks, vq, vs)
