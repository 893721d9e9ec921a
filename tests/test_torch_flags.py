"""The flag kernels B1-B5 of the port (mpi_acx_torch.ops.flags) against the
JAX package's Pallas kernels (mpi_acx_tpu.ops.flags, interpret mode on the
CPU): the same numpy inputs from a seed, exact equality, the edge cases of
the padded TPU tables included (an index outside the table changes nothing
and reads 0, no index polls as arrived, repeated indices are harmless).
Mirrors tests/test_ops.py's TestFlagKernels. On CPU tensors the wrappers
run their plain versions, so no launch is counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_torch.ops import flags as tf
from mpi_acx_tpu.ops import flags as jf


def _table(n, seed):
    """A table of random protocol states 0-5."""
    return np.random.default_rng(seed).integers(0, 6, n).astype(np.int32)


def _both(fn_t, fn_j, table, *args):
    """Run the torch and JAX versions on copies of ``table``; the torch
    mutator must return its own (updated) input."""
    t_in = torch.from_numpy(table.copy())
    got = fn_t(t_in, *args)
    want = fn_j(jnp.asarray(table), *args)
    return t_in, got, np.asarray(want)


# Index cases per table size: in range, both ends, outside on each side
# (including inside the TPU kernels' padding, n..1023), far outside int32
# is tested separately.
def _indices(n):
    return sorted({0, n - 1, n // 2, -1, n, n + 5, 1023, 1024, -100})


@pytest.mark.parametrize("n,seed", [(1, 0), (16, 1), (1000, 2)])
def test_pready_matches_jax(n, seed):
    table = _table(n, seed)
    for idx in _indices(n):
        t_in, got, want = _both(tf.pready, jf.pready, table, idx)
        assert got is t_in                      # updated in place
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(idx))
    assert tf.pready.launches == 0


def test_pready_tensor_index():
    # A 0-d int32 tensor on the table's device (JAX: a traced index).
    table = _table(16, 3)
    got = tf.pready(torch.from_numpy(table.copy()),
                    torch.tensor(3, dtype=torch.int32))
    want = jax.jit(jf.pready)(jnp.asarray(table), jnp.int32(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3] == tf.PENDING


@pytest.mark.parametrize("n,seed", [(16, 4), (1000, 5)])
def test_pready_many_matches_jax(n, seed):
    table = _table(n, seed)
    rng = np.random.default_rng(seed)
    cases = [np.array([1, 7, n - 1]), np.array([3, 3, 3, 0]),
             np.array([-1, n, n + 200, 2]),
             rng.integers(-5, n + 5, 40)]
    for idxs in cases:
        idxs = idxs.astype(np.int32)
        t_in, got, want = _both(tf.pready_many, jf.pready_many, table,
                                jnp.asarray(idxs))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(idxs))
        got2 = tf.pready_many(torch.from_numpy(table.copy()),
                              torch.from_numpy(idxs))
        np.testing.assert_array_equal(got2.numpy(), want)
    assert tf.pready_many.launches == 0


@pytest.mark.parametrize("n,seed", [(1, 6), (16, 7), (1000, 8)])
def test_parrived_matches_jax(n, seed):
    table = _table(n, seed)
    table[n // 2] = tf.COMPLETED
    for idx in _indices(n):
        _, got, want = _both(tf.parrived, jf.parrived, table, idx)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want), idx
    assert int(tf.parrived(torch.from_numpy(table),
                           torch.tensor(n // 2, dtype=torch.int32))) == 1
    assert tf.parrived.launches == 0


@pytest.mark.parametrize("n,seed", [(16, 9), (1000, 10)])
def test_parrived_all_matches_jax(n, seed):
    table = _table(n, seed)
    done = np.arange(0, n, 3)
    table[done] = tf.COMPLETED
    cases = [done, done[:2], np.array([done[0], 1]), np.array([n]),
             np.array([done[0], -1]), np.concatenate([done, done])]
    for idxs in cases:
        idxs = idxs.astype(np.int32)
        _, got, want = _both(tf.parrived_all, jf.parrived_all, table,
                             jnp.asarray(idxs))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want), idxs
    assert tf.parrived_all.launches == 0


def test_parrived_all_of_no_index_is_one():
    # The TPU kernel's loop over k = 0 indices leaves its accumulator True;
    # the JAX call itself refuses a (1, 0) index block in interpret mode,
    # so the value is held to the kernel body's loop.
    table = np.full(8, tf.RESERVED, np.int32)
    assert int(tf.parrived_all(torch.from_numpy(table), [])) == 1
    assert bool(jax.lax.fori_loop(0, 0, lambda i, acc: False,
                                  jnp.bool_(True)))
    with pytest.raises(TypeError):
        jf.parrived_all(jnp.asarray(table), jnp.zeros((0,), jnp.int32))
    got = tf.pready_many(torch.from_numpy(table.copy()), [])
    np.testing.assert_array_equal(got.numpy(), table)


def test_pready_index_outside_int32_changes_nothing():
    table = _table(16, 11)
    got = tf.pready(torch.from_numpy(table.copy()), 2 ** 40)
    np.testing.assert_array_equal(got.numpy(), table)
    assert int(tf.parrived(torch.from_numpy(table), -2 ** 40)) == 0


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("shape,seed", [((8, 128), 12), ((16, 256), 13)])
def test_produce_and_pready_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 100
    table = _table(16, seed)
    # The JAX workers' producer and identity: bit-exact against the Pallas
    # kernel (a product by 2 is exact, so one rounding or two agree).
    for produce_t, produce_j in [
            (tf.Affine(2.0, 1.0), lambda t: t * 2.0 + 1.0),
            (tf.identity, lambda t: t)]:
        for idx in (5, 16, -1):
            t_flags = torch.from_numpy(table.copy())
            payload, got = tf.produce_and_pready(
                produce_t, torch.from_numpy(x), t_flags, idx)
            want_p, want_f = jf.produce_and_pready(
                produce_j, jnp.asarray(x), jnp.asarray(table), idx)
            assert got is t_flags
            np.testing.assert_array_equal(got.numpy(), np.asarray(want_f))
            np.testing.assert_array_equal(_bits(payload), _bits(want_p))
    assert tf.produce_and_pready.launches == 0


def test_produce_affine_rounds_twice():
    """Affine rounds after the product and after the sum (the card's
    __fmul_rn/__fadd_rn), bit for bit as JAX's eager ``t * a + b``. XLA's
    CPU compiler contracts the jitted Pallas kernel's product and sum into
    one FMA, one rounding: that result differs by at most half an ulp of
    the product plus one ulp of the result."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((8, 128)).astype(np.float32) * 100
    a, b = -0.37, 5.25
    payload, _ = tf.produce_and_pready(
        tf.Affine(a, b), torch.from_numpy(x),
        torch.zeros(4, dtype=torch.int32), 0)
    eager = jnp.asarray(x) * a + b
    np.testing.assert_array_equal(_bits(payload), _bits(eager))
    fused, _ = jf.produce_and_pready(lambda t: t * a + b, jnp.asarray(x),
                                     jnp.zeros(4, jnp.int32), 0)
    fused = np.asarray(fused)
    prod = x * np.float32(a)
    slack = np.spacing(np.abs(prod)) / 2 + np.spacing(np.abs(fused))
    assert (np.abs(payload.numpy() - fused) <= slack).all()
    assert (payload.numpy() != fused).any()     # the contraction is real


def test_produce_and_pready_any_callable_on_cpu():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    payload, flags = tf.produce_and_pready(
        lambda t: t.square(), x, torch.full((4,), tf.RESERVED,
                                            dtype=torch.int32), 2)
    assert torch.equal(payload, x.square())
    assert flags.tolist() == [1, 1, 2, 1]
    assert tf.identity(x) is not x and torch.equal(tf.identity(x), x)


@pytest.mark.parametrize("idx", [3, 16, -1])
def test_produce_any_callable_matches_jax(idx):
    """A producer that is not identity or Affine (the caller's own code,
    here tanh(t) * 3) against JAX's ``produce_and_pready`` tracing the
    same function into its kernel: the flag table exactly, the payload
    within 4 ulps (tanh is not correctly rounded in either library: the
    two differ by up to 2 ulps of tanh before the product by 3)."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((8, 128)).astype(np.float32) * 2
    table = _table(16, 15)
    t_flags = torch.from_numpy(table.copy())
    payload, got = tf.produce_and_pready(lambda t: torch.tanh(t) * 3.0,
                                         torch.from_numpy(x), t_flags, idx)
    want_p, want_f = jf.produce_and_pready(lambda t: jnp.tanh(t) * 3.0,
                                           jnp.asarray(x),
                                           jnp.asarray(table), idx)
    assert got is t_flags
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_f))
    want_p = np.asarray(want_p)
    assert payload.shape == want_p.shape
    assert (np.abs(payload.numpy() - want_p)
            <= 4 * np.spacing(np.abs(want_p).astype(np.float32))).all()
    assert tf.produce_and_pready.launches == 0 and tf.pready.launches == 0


def test_state_machine_roundtrip_matches_native_protocol():
    # AVAILABLE->RESERVED->PENDING->...->COMPLETED (include/acx/state.h).
    assert (tf.AVAILABLE, tf.RESERVED, tf.PENDING, tf.ISSUED, tf.COMPLETED,
            tf.CLEANUP) == (jf.AVAILABLE, jf.RESERVED, jf.PENDING,
                            jf.ISSUED, jf.COMPLETED, jf.CLEANUP)
    flags = torch.full((8,), tf.AVAILABLE, dtype=torch.int32)
    flags[0] = tf.RESERVED
    tf.pready(flags, 0)
    assert flags[0] == tf.PENDING
    flags[0] = tf.COMPLETED
    assert int(tf.parrived(flags, 0)) == 1


def test_select_flags():
    kern = tf.select_flags(True)
    assert kern == tf.select_flags(None)
    assert kern[0] is tf.pready and kern[4] is tf.produce_and_pready
    plain = tf.select_flags(False)
    assert plain[0] is tf.pready_reference
    assert plain[3] is tf.parrived_all_reference


def test_cuda_wrappers_refuse_what_the_card_lacks():
    """A table that is not on the CPU goes to the kernel; checks before the
    launch refuse what the kernels do not take (no card is needed for
    these)."""
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        tf.pready(meta, 0)
    with pytest.raises(TypeError, match="int32"):
        tf.parrived(torch.zeros(4, dtype=torch.int64, device="meta"), 0)
    with pytest.raises(ValueError, match="no kernel"):
        tf.produce_and_pready(tf.identity, torch.zeros(2, 2), meta, 0)
