"""The port's token data (mpi_acx_torch/data.py) held against the JAX
package's ``data.py`` on the same token files.

``batches`` is the same numpy code on both sides, so its windows are
held **bit-equal** to JAX's, sequential and seeded. ``prefetch`` on the
CPU (``device="cpu"``) yields tensors equal to JAX's prefetched arrays,
in order; its error propagation and its release on abandonment are
JAX's. The card's side stream is driven by ``chip_smoke.py`` phase 5e.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax

from mpi_acx_tpu import data as jdata
from mpi_acx_torch import data as tdata


def _token_file(tmp_path, n, vocab=50257, seed=0, dtype=np.uint16):
    arr = np.random.default_rng(seed).integers(0, vocab, n).astype(dtype)
    path = tmp_path / "tokens.bin"
    arr.tofile(path)
    return str(path), arr


def _both(path, dtype=np.uint16):
    return (jdata.TokenDataset(path, dtype=dtype),
            tdata.TokenDataset(path, dtype=dtype))


def test_memmap_view_equals_jax(tmp_path):
    path, arr = _token_file(tmp_path, 1000)
    jds, tds = _both(path)
    assert isinstance(tds.tokens, np.memmap)
    assert len(tds) == len(jds) == len(arr)
    np.testing.assert_array_equal(tds.tokens, jds.tokens)


@pytest.mark.parametrize("seed", [None, 0, 7, 12345])
@pytest.mark.parametrize("batch,seq", [(4, 8), (3, 31), (1, 64)])
def test_batches_bit_equal_to_jax(tmp_path, seed, batch, seq):
    """Sequential (seed None) and seeded windows over the same uint16
    file: every batch bit-equal, the same number of batches."""
    path, _ = _token_file(tmp_path, 5003)
    jds, tds = _both(path)
    n = None if seed is None else 9
    want = list(jdata.batches(jds, batch, seq, seed=seed, n_batches=n))
    got = list(tdata.batches(tds, batch, seq, seed=seed, n_batches=n))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.shape == w.shape == (batch, seq + 1)
        np.testing.assert_array_equal(g, w)


def test_batches_of_a_uint32_file_and_an_array(tmp_path):
    path, _ = _token_file(tmp_path, 3000, vocab=128256, dtype=np.uint32)
    jds, tds = _both(path, np.uint32)
    for g, w in zip(tdata.batches(tds, 2, 100, seed=3, n_batches=4),
                    jdata.batches(jds, 2, 100, seed=3, n_batches=4)):
        np.testing.assert_array_equal(g, w)
    arr = np.arange(50, dtype=np.int32)
    np.testing.assert_array_equal(
        next(tdata.batches(tdata.TokenDataset.from_array(arr), 2, 4,
                           seed=1)),
        next(jdata.batches(jdata.TokenDataset.from_array(arr), 2, 4,
                           seed=1)))


def test_too_short_and_empty_files_raise_as_jax(tmp_path):
    path, _ = _token_file(tmp_path, 6)
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="shorter than window 9"):
            next(mod.batches(mod.TokenDataset(path), 1, 8))
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    with pytest.raises(ValueError) as want:
        jdata.TokenDataset(str(empty))
    with pytest.raises(ValueError) as got:
        tdata.TokenDataset(str(empty))
    assert str(got.value) == str(want.value)


def test_prefetch_values_equal_jax_in_order(tmp_path):
    path, _ = _token_file(tmp_path, 4000)
    jds, tds = _both(path)
    want = list(jdata.prefetch(jdata.batches(jds, 8, 32, seed=3,
                                             n_batches=6)))
    got = list(tdata.prefetch(tdata.batches(tds, 8, 32, seed=3,
                                            n_batches=6), device="cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(jax.device_get(
            w)))


def test_prefetch_stages_tuples_and_dicts():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    items = [(a, {"t": a + 1}), (a * 2, {"t": a - 1})]
    got = list(tdata.prefetch(iter(items), size=1, device="cpu"))
    for g, (x, d) in zip(got, items):
        assert isinstance(g, tuple) and isinstance(g[1], dict)
        np.testing.assert_array_equal(g[0].numpy(), x)
        np.testing.assert_array_equal(g[1]["t"].numpy(), d["t"])


def test_prefetch_propagates_source_errors():
    def bad():
        yield np.zeros((2, 3), np.int32)
        raise RuntimeError("source died")
    it = tdata.prefetch(bad(), device="cpu")
    assert next(it).shape == (2, 3)
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


def _daemon_threads():
    return {t.ident for t in threading.enumerate() if t.daemon}


def test_prefetch_abandonment_releases_worker():
    """Closing the generator after one batch (what a ``break`` does)
    retires the worker, which was blocked on a full queue."""
    before = _daemon_threads()
    ds = tdata.TokenDataset.from_array(np.arange(4000, dtype=np.int32))
    it = tdata.prefetch(tdata.batches(ds, 4, 8, seed=0, n_batches=100),
                        size=2, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while _daemon_threads() - before and time.time() < deadline:
        time.sleep(0.05)
    assert not _daemon_threads() - before, "prefetch worker leaked"


def test_prefetch_feeds_the_train_step():
    """Prefetched windows drive the port's train step; the losses equal
    those of the same windows handed over as arrays."""
    from mpi_acx_torch import train
    from mpi_acx_torch.models import transformer as tfm
    from mpi_acx_torch.parallel.mesh import mesh_from_devices
    cfg = tfm.tiny_config(vocab=251, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, max_seq=16)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.stage_slice(tfm.init_params(cfg, seed=0, device="cpu"), 1)
    grad_fn, _ = train.make_loss_and_grads(
        cfg, mesh_from_devices({"dp": 1, "pp": 1, "tp": 1}), 1,
        device="cpu")
    ds = tdata.TokenDataset.from_array(
        (np.arange(5000) % 251).astype(np.uint16))

    def losses(windows):
        return [grad_fn(params, w[None, :, :-1], w[None, :, 1:])[0].item()
                for w in windows]

    got = losses(tdata.prefetch(tdata.batches(ds, 4, 8, seed=2,
                                              n_batches=3), device="cpu"))
    want = losses(torch.from_numpy(w) for w in tdata.batches(
        ds, 4, 8, seed=2, n_batches=3))
    assert got == want and all(np.isfinite(got))
