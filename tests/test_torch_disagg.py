"""Disaggregated prefill/decode serving (mpi_acx_torch/models/disagg.py)
against the JAX package's (mpi_acx_tpu/models/disagg.py), on a tiny f32
configuration on the CPU: the layerwise prefill against JAX's and against
the port's own ``transformer.prefill``; loopback disagg serving (the whole
wire path over a loopback partitioned channel) bit-equal to the port's
monolithic ``serve_greedy(kv_int8=True)`` in its three variants, whose
tokens equal JAX's; the two mid-handoff faults of tests/test_disagg.py;
``fleet_roles`` and the metrics' fields against JAX's.

Both packages get the same weights (the JAX tree through
``params_from_jax``) and the same prompts (numpy seed). The loopback runs
on the port's runtime binding over build/libtpuacx.so, one module-scoped
runtime for the file; no JAX runtime lives in this process.
"""

import dataclasses
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import disagg as jd
from mpi_acx_tpu.models import serving as js
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import disagg as td
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NEW = [6, 3, 9, 4, 5]


@pytest.fixture(scope="module")
def rt():
    subprocess.run(["make", "-C", REPO, "lib", "tools"], check=True,
                   capture_output=True, timeout=600)
    from mpi_acx_torch import runtime
    r = runtime.Runtime()
    yield r
    r.finalize()


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jt.tiny_config(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.tiny_config(), dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n in (5, 11, 3, 17, 8)]
    fns = ts.make_server_fns(tparams, tcfg, tt, chunk=1, kv_int8=True)
    mono = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                           max_len=64, kv_int8=True, server_fns=fns,
                           device="cpu")
    return jcfg, jparams, tcfg, tparams, prompts, fns, mono


def _assert_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"request {i}")


def _layerwise(fns, tokens, last, n_layers):
    embed_fn, layer_fn, head_fn, quant_fn = fns
    x = embed_fn(tokens)
    codes = []
    for layer in range(n_layers):
        x, k, v = layer_fn(x, layer)
        codes.append([np.asarray(a) for a in quant_fn(k, v)])
    return np.asarray(head_fn(x, last)), [np.stack(c) for c in zip(*codes)]


def test_layerwise_prefill_matches_jax_and_prefill(setup):
    """The hoisted layer loop gives the port's ``transformer.prefill``
    bit for bit (logits, int8 codes, f32 scales), and JAX's layerwise
    prefill within 1e-5 in the logits with the same int8 codes (no code
    flips at these inputs). The f32 scales agree to 2e-6 relative, not
    bit for bit: XLA and PyTorch sum the qkv product in other orders, so
    K and V differ by an ulp or two (relative 5e-7 here), and so does
    each scale, max|x| / 127."""
    jcfg, jparams, tcfg, tparams, _, _, _ = setup
    S, bucket = 11, 16
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :S] = np.arange(S) * 37 % tcfg.vocab
    t_logits, t_codes = _layerwise(
        td.make_layerwise_prefill_fns(tparams, tcfg),
        torch.from_numpy(tokens), S - 1, tcfg.n_layers)
    mono_logits, cache = tt.prefill(tparams, tcfg, torch.from_numpy(tokens),
                                    bucket, kv_int8=True, last_index=S - 1)
    np.testing.assert_array_equal(t_logits, mono_logits.numpy())
    for got, key in zip(t_codes, ("k", "ks", "v", "vs")):
        np.testing.assert_array_equal(got, cache[key].numpy())
    j_logits, j_codes = _layerwise(
        jd.make_layerwise_prefill_fns(jparams, jcfg), jnp.asarray(tokens),
        S - 1, jcfg.n_layers)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)
    for got, want in zip(t_codes[::2], j_codes[::2]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_codes[1::2], j_codes[1::2]):
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_layerwise_prefill_refuses_other_families(setup):
    from mpi_acx_torch.models import llama, moe_transformer
    _, _, tcfg, tparams, _, _, _ = setup
    for fam in (llama, moe_transformer):
        with pytest.raises(NotImplementedError, match=fam.__name__):
            td.make_layerwise_prefill_fns(tparams, tcfg, fam)


def test_monolithic_int8_serve_equals_jax(setup):
    """The reference of the loopback tests below: the port's monolithic
    int8 serve gives JAX's ``serve_greedy(kv_int8=True)`` tokens."""
    jcfg, jparams, _, _, prompts, _, mono = setup
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=2,
                           max_len=64, kv_int8=True)
    _assert_equal(want, mono)


@pytest.mark.parametrize("variant", [dict(prefill_kv_int8=False),
                                     dict(prefill_kv_int8=True),
                                     dict(overlap=False)],
                         ids=["quantize_at_wire", "quantize_at_compute",
                              "ship_after_prefill"])
def test_loopback_disagg_equals_monolithic(rt, setup, variant):
    _, _, tcfg, tparams, prompts, fns, mono = setup
    dis = td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                                 max_len=64, server_fns=fns, rt=rt,
                                 device="cpu", **variant)
    _assert_equal(mono, dis)
    m = dis.metrics
    assert isinstance(m, td.DisaggMetrics)
    assert len(m.handoffs) == len(prompts) == m.prefills
    assert all(h.layers == tcfg.n_layers for h in m.handoffs)
    assert all(h.overlap == variant.get("overlap", True)
               for h in m.handoffs)
    # Buckets 8, 16, 8, 32, 8; 4 layers of 288 B a bucket position.
    part = 2 * 4 * 32 + 2 * 4 * 4
    assert [h.wire_bytes for h in m.handoffs] == [
        4 * b * part for b in (8, 16, 8, 32, 8)]
    assert m.requeues == 0 and m.new_tokens == sum(N_NEW)


def test_midhandoff_peer_loss_requeues_uncharged(rt, setup):
    """A handoff that dies shaped like peer loss before layer 2's publish:
    the request is requeued without charging its budget (retries 0
    allowed), the round is completed so the channel restarts, and the
    retry serves the same tokens."""
    from mpi_acx_torch.runtime import ERR_PEER_DEAD, AcxPeerDeadError
    _, _, tcfg, tparams, prompts, fns, mono = setup
    fired = []

    def ship_fault(rid, layer):
        if rid == 1 and layer == 2 and not fired:
            fired.append((rid, layer))
            raise AcxPeerDeadError("tpu-acx: peer dead (injected)",
                                   ERR_PEER_DEAD, 0, 0)

    dis = td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                                 max_len=64, server_fns=fns, rt=rt,
                                 ship_fault=ship_fault,
                                 max_request_retries=0, device="cpu")
    assert fired == [(1, 2)]
    _assert_equal(mono, dis)
    assert dis.metrics.peer_requeues >= 1
    assert dis.metrics.requeues >= 1
    assert dis.metrics.per_request[1].retries == 0


def test_midhandoff_fault_is_charged(rt, setup):
    _, _, tcfg, tparams, prompts, fns, mono = setup
    fired = []

    def ship_fault(rid, layer):
        if rid == 3 and layer == 1 and not fired:
            fired.append((rid, layer))
            raise RuntimeError("injected mid-handoff failure")

    dis = td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                                 max_len=64, server_fns=fns, rt=rt,
                                 ship_fault=ship_fault,
                                 max_request_retries=2, device="cpu")
    assert fired == [(3, 1)]
    _assert_equal(mono, dis)
    assert dis.metrics.per_request[3].retries == 1
    assert dis.metrics.peer_requeues == 0
    with pytest.raises(RuntimeError, match="past max_request_retries=0"):
        fired.clear()
        td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                               max_len=64, server_fns=fns, rt=rt,
                               ship_fault=ship_fault, max_request_retries=0,
                               device="cpu")


@pytest.fixture
def one_thread():
    """Tiny serves on one intra-op thread: on a loaded host a pool of
    threads turns each small op into a wait of milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chunk", [1, 3])
def test_servers_share_one_schedule(rt, setup, chunk, one_thread):
    """The fixed-slot, paged and loopback servers run one scheduler: on
    the same requests, with the paged defaults (no prefix cache, no SLO
    gate, enough pages), they step, prefill and fill their slots alike,
    and give the same tokens."""
    _, _, tcfg, tparams, prompts, _, _ = setup
    kw = dict(n_slots=2, max_len=64, chunk=chunk, device="cpu")
    served = [ts.serve_greedy(tparams, tcfg, prompts, N_NEW, kv_int8=True,
                              **kw),
              ts.serve_paged_greedy(tparams, tcfg, prompts, N_NEW,
                                    kv_int8=True, **kw),
              td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, rt=rt,
                                     **kw)]
    fixed = served[0]
    for got in served[1:]:
        _assert_equal(fixed, got)
        assert [(b.metrics.steps, b.metrics.prefills,
                 b.metrics.slot_occupancy_mean) for b in (fixed, got)] == \
            [(fixed.metrics.steps, len(prompts),
              fixed.metrics.slot_occupancy_mean)] * 2
    assert fixed.metrics.steps > 0


def test_server_fns_must_be_int8(rt, setup):
    _, _, tcfg, tparams, prompts, _, _ = setup
    bf = ts.make_server_fns(tparams, tcfg, tt, chunk=1)
    with pytest.raises(ValueError, match="int8"):
        td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                               max_len=64, server_fns=bf, rt=rt,
                               device="cpu")


SPECS = [None, "", "prefill,decode,decode", "decode", "prefill",
         "prefill, decode ,decode", "prefill,prefill", "decode,decode",
         "prefill,decode", "bogus", "prefill,bogus,decode"]


@pytest.mark.parametrize("spec", SPECS)
def test_fleet_roles_equal_jax(spec, monkeypatch):
    if spec is None:
        monkeypatch.delenv("ACX_ROLE", raising=False)
    else:
        monkeypatch.setenv("ACX_ROLE", spec)
    for size in (1, 2, 3):
        try:
            want = jd.fleet_roles(size)
        except ValueError:
            with pytest.raises(ValueError, match="ACX_ROLE"):
                td.fleet_roles(size)
            continue
        assert td.fleet_roles(size) == want


def test_fleet_mode_needs_a_runtime(setup, monkeypatch):
    _, _, tcfg, tparams, prompts, _, _ = setup
    monkeypatch.setenv("ACX_ROLE", "prefill,decode")
    with pytest.raises(ValueError, match="explicit Runtime"):
        td.serve_disagg_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                               max_len=64, device="cpu")


def test_metrics_fields_equal_jax():
    for tcls, jcls in ((td.DisaggMetrics, jd.DisaggMetrics),
                       (td.HandoffTelemetry, jd.HandoffTelemetry),
                       (ts.ServingMetrics, js.ServingMetrics)):
        assert [f.name for f in dataclasses.fields(tcls)] == \
            [f.name for f in dataclasses.fields(jcls)]
    assert np.array_equal(td._hdr_wire(3, 11, 16), jd._hdr_wire(3, 11, 16))
    assert np.array_equal(td._fin_wire(3, 7, 120, 4),
                          jd._fin_wire(3, 7, 120, 4))
