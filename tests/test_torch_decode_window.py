"""The port's ``decoding.decode_layer_scan`` held against the JAX
package's on windows of W tokens (W = 1 is the one-token decode step;
W = k is speculative decoding's target pass, models/speculative.py).

Both loops get the same layers, hidden states and caches (numpy seed 0)
and the same qkv/attend callables written in each framework. q/k/v are
elementwise products of the first 3 H D hidden values, which no layer
changes (no matmul), so both sides write the same cache rows bit for
bit; attention is each package's dense decode reference, whose output
each layer adds to the last H D values. Checked: every cache tensor
bit-equal and the returned x within 1e-5 (f32) or bf16's 4e-2, at W of 1,
3 and 4, scalar and per-slot positions (one slot at ``max_len - W + 1``,
where the write starts at ``max_len - W`` as ``dynamic_update_slice``
clamps it), over f32, bf16 and int8 caches. The JAX loop is jitted, as
every JAX decode path runs it (its ``kv_quant`` is then the jitted form
the port copies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import decoding as jd
from mpi_acx_torch.models import decoding as td

B, H, D, L, MAX_LEN = 4, 2, 8, 2, 12
HD = H * D


def _qkv(x, a, reshape):
    """q, k, v [B, W, H, D]: three slices of x[..., :3 H D] * a."""
    y = x[..., :3 * HD] * a
    Bx, W = x.shape[:2]
    return tuple(reshape(y[..., j * HD:(j + 1) * HD], (Bx, W, H, D))
                 for j in range(3))


def _inputs(W, dtype, seed=0):
    rng = np.random.default_rng(seed + W)
    return dict(
        a=rng.standard_normal((L, 3 * HD)).astype(np.float32),
        x=rng.standard_normal((B, W, 4 * HD)).astype(np.float32),
        kc=rng.standard_normal((L, B, MAX_LEN, H, D)).astype(np.float32),
        vc=rng.standard_normal((L, B, MAX_LEN, H, D)).astype(np.float32))


def _positions(W, mode):
    edge = MAX_LEN - W + 1
    return {"scalar": np.int32(5), "scalar_edge": np.int32(edge),
            "slots": np.asarray([0, 3, edge, 6], np.int32)}[mode]


def _run_jax(inp, pos, cache):
    dt = jnp.bfloat16 if cache == "bf16" else jnp.float32

    def qkv_fn(lp, x, _pos):
        return _qkv(x, lp["a"].astype(x.dtype), jnp.reshape)

    def attend_fn(lp, x, q, kc, vc, p):
        o = jd.grouped_decode_attend(q, kc, vc, p, MAX_LEN, 1, flash=False)
        return x + jnp.concatenate(
            [jnp.zeros_like(x[..., :3 * HD]), o.astype(x.dtype)], axis=-1)

    @jax.jit
    def run(layers, x, kc, vc, p):
        if cache == "int8":
            from mpi_acx_tpu.ops.kvquant import kv_quant
            (kq, ksc), (vq, vsc) = kv_quant(kc), kv_quant(vc)
            return jd.decode_layer_scan(layers, x, kq, vq, p, qkv_fn,
                                        attend_fn, ksc_all=ksc, vsc_all=vsc)
        return jd.decode_layer_scan(layers, x, kc.astype(dt), vc.astype(dt),
                                    p, qkv_fn, attend_fn)

    out = run({"a": jnp.asarray(inp["a"])}, jnp.asarray(inp["x"]).astype(dt),
              jnp.asarray(inp["kc"]), jnp.asarray(inp["vc"]),
              jnp.asarray(pos))
    return [np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16
                       else t) for t in out]


def _run_torch(inp, pos, cache):
    from mpi_acx_torch.ops.kvquant import kv_quant
    dt = torch.bfloat16 if cache == "bf16" else torch.float32

    def qkv_fn(lp, x, _pos):
        return _qkv(x, lp["a"].to(x.dtype), torch.reshape)

    def attend_fn(lp, x, q, kc, vc, p):
        o = td.grouped_decode_attend(q, kc, vc, p, MAX_LEN, 1, flash=False)
        return x + torch.cat(
            [torch.zeros_like(x[..., :3 * HD]), o.to(x.dtype)], dim=-1)

    kc, vc = torch.from_numpy(inp["kc"]), torch.from_numpy(inp["vc"])
    x = torch.from_numpy(inp["x"]).to(dt)
    layers = {"a": torch.from_numpy(inp["a"])}
    p = torch.as_tensor(pos)
    if cache == "int8":
        (kq, ksc), (vq, vsc) = kv_quant(kc), kv_quant(vc)
        out = td.decode_layer_scan(layers, x, kq, vq, p, qkv_fn, attend_fn,
                                   ksc_all=ksc, vsc_all=vsc)
    else:
        out = td.decode_layer_scan(layers, x, kc.to(dt), vc.to(dt), p,
                                   qkv_fn, attend_fn)
    return [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for t in out]


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["scalar", "scalar_edge", "slots"])
@pytest.mark.parametrize("W", [1, 3, 4])
def test_decode_layer_scan_window_matches_jax(W, mode, cache):
    inp = _inputs(W, cache)
    pos = _positions(W, mode)
    want = _run_jax(inp, pos, cache)
    got = _run_torch(inp, pos, cache)
    assert len(got) == len(want) == (5 if cache == "int8" else 3)
    tol = 4e-2 if cache == "bf16" else 1e-5
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)
    for name, g, w in zip(("k", "v", "ks", "vs"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_window_rows_land_at_each_slot_position():
    """All W rows of each slot are written at pos[b]..pos[b]+W-1, a slot
    at the cache's end starting at max_len - W, and no other row moves."""
    W = 4
    inp = _inputs(W, "f32", seed=3)
    pos = _positions(W, "slots")
    kc0 = inp["kc"].copy()
    _, kc, _ = _run_torch(inp, pos, "f32")
    y = inp["x"][..., :3 * HD] * inp["a"][0]
    k_new = y[..., HD:2 * HD].reshape(B, W, H, D)
    for b in range(B):
        start = min(int(pos[b]), MAX_LEN - W)
        np.testing.assert_array_equal(kc[0, b, start:start + W], k_new[b])
        keep = np.ones(MAX_LEN, bool)
        keep[start:start + W] = False
        np.testing.assert_array_equal(kc[0, b, keep], kc0[0, b, keep])
