"""The port's checkpoints (mpi_acx_torch/checkpoint.py) against the JAX
package's Orbax ``Checkpointer``.

The file format differs on purpose (``torch.save`` into one directory a
step, not Orbax's), so what is held to JAX is the behaviour: the steps a
directory holds after the same saves at ``max_to_keep=2`` (a step at or
below the newest is not written), ``FileNotFoundError`` on an empty
directory, and ``warm_start``'s ``(None, None)``. A resumed tiny GPT-2
AdamW run through the port's train step is **bit-equal** to the
uninterrupted one, losses and parameters.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_acx_tpu import checkpoint as jckpt
from mpi_acx_torch import checkpoint as tckpt
from mpi_acx_torch import train
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices

MESH = {"dp": 1, "pp": 1, "tp": 1}


def test_steps_and_retention_equal_orbax(tmp_path):
    saves = [1, 2, 3, 2, 1, 5, 5, 8]
    with jckpt.Checkpointer(str(tmp_path / "j"), max_to_keep=2) as j, \
            tckpt.Checkpointer(str(tmp_path / "t"), max_to_keep=2) as t:
        assert t.latest_step() is j.latest_step() is None
        assert t.all_steps() == j.all_steps() == []
        for s in saves:
            j.save(s, {"w": jnp.full((4,), float(s))})
            t.save(s, {"w": torch.full((4,), float(s))})
            assert t.all_steps() == j.all_steps(), s
            assert t.latest_step() == j.latest_step(), s
        for s in t.all_steps():
            np.testing.assert_array_equal(
                t.restore(s)["w"].numpy(), np.asarray(j.restore(s)["w"]))
    assert sorted(os.listdir(tmp_path / "t")) == ["5", "8"]


def test_restore_from_an_empty_directory_raises_as_jax(tmp_path):
    for mod, sub in ((jckpt, "j"), (tckpt, "t")):
        with mod.Checkpointer(str(tmp_path / sub)) as c:
            with pytest.raises(FileNotFoundError, match="no checkpoints"):
                c.restore()
    assert tckpt.warm_start(str(tmp_path / "t"), like={}) == (None, None)
    assert jckpt.warm_start(str(tmp_path / "j"), like={}) == (None, None)


def _tiny():
    cfg = dataclasses.replace(
        tfm.tiny_config(vocab=61, d_model=32, n_heads=2, n_layers=2,
                        d_ff=64, max_seq=16), dtype=torch.float32)
    return cfg, tfm.stage_slice(tfm.init_params(cfg, seed=4, device="cpu"),
                                1)


def _adamw(params):
    return torch.optim.AdamW(train.param_leaves(params), lr=1e-3,
                             weight_decay=1e-4)


def _step(cfg, opt):
    return train.make_train_step_optim(cfg, mesh_from_devices(MESH), 2, opt,
                                       device="cpu")[0]


def _batch():
    tok = np.random.default_rng(5).integers(0, 61, (2, 2, 16), np.int32)
    return tok, np.roll(tok, -1, -1)


def test_a_resumed_adamw_run_is_bit_equal(tmp_path):
    """Five AdamW steps uninterrupted; then steps 0-2, a save with
    wait=False, and steps 3-4 from a fresh model and optimizer restored
    with ``like``: the same losses and parameters, bit for bit."""
    cfg, params = _tiny()
    opt = _adamw(params)
    step = _step(cfg, opt)
    want = [step(params, *_batch())[0].item() for _ in range(5)]

    cfg, params = _tiny()
    opt = _adamw(params)
    step = _step(cfg, opt)
    got = [step(params, *_batch())[0].item() for _ in range(3)]
    with tckpt.Checkpointer(str(tmp_path / "run")) as ckpt:
        ckpt.save(2, {"params": params, "opt": opt.state_dict(), "step": 2},
                  wait=False)
        # The state was copied at the call: updating it now changes
        # nothing saved.
        step(params, *_batch())
        ckpt.wait_until_finished()
        _, fresh = _tiny()
        fresh_opt = _adamw(fresh)
        state = ckpt.restore(like={"params": fresh,
                                   "opt": fresh_opt.state_dict(),
                                   "step": 0})
    assert state["step"] == 2
    with torch.no_grad():
        for p, r in zip(train.param_leaves(fresh),
                        train.param_leaves(state["params"])):
            p.copy_(r)
    fresh_opt.load_state_dict(state["opt"])
    step = _step(cfg, fresh_opt)
    got += [step(fresh, *_batch())[0].item() for _ in range(2)]
    assert got == want
    cfg, params = _tiny()
    opt = _adamw(params)
    step = _step(cfg, opt)
    for _ in range(5):
        step(params, *_batch())
    for a, b in zip(train.param_leaves(fresh), train.param_leaves(params)):
        assert torch.equal(a, b)


def test_restore_without_like_gives_cpu_tensors_in_saved_dtypes(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
             "opt": {"state": {0: {"step": torch.tensor(3.0),
                                   "m": torch.ones(2)}},
                     "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99),
                                       "params": [0]}]},
             "note": "x", "n": 7}
    with tckpt.Checkpointer(str(tmp_path)) as c:
        c.save(0, state)
        got = c.restore()
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], state["w"])
    assert got["opt"]["param_groups"] == state["opt"]["param_groups"]
    assert torch.equal(got["opt"]["state"][0]["m"], torch.ones(2))
    assert (got["note"], got["n"]) == ("x", 7)


def test_restore_lands_in_like_dtypes_and_checks_shapes(tmp_path):
    with tckpt.Checkpointer(str(tmp_path)) as c:
        c.save(1, {"w": torch.arange(4.0), "extra": torch.ones(2)})
        got = c.restore(like={"w": torch.zeros(4, dtype=torch.float64)})
        assert got["w"].dtype == torch.float64
        assert torch.equal(got["w"], torch.arange(4.0, dtype=torch.float64))
        assert got["extra"].dtype == torch.float32
        assert got["extra"].device.type == "cpu"
        with pytest.raises(ValueError, match="like holds"):
            c.restore(like={"w": torch.zeros(5)})
        with pytest.raises(ValueError, match="lacks"):
            c.restore(like={"w": torch.zeros(4), "v": torch.zeros(1)})


def test_a_partial_write_is_not_a_step(tmp_path):
    with tckpt.Checkpointer(str(tmp_path)) as c:
        c.save(3, {"w": torch.ones(2)})
        os.makedirs(tmp_path / ".tmp-9-cut")
        (tmp_path / ".tmp-9-cut" / "state.pt").write_bytes(b"partial")
        os.makedirs(tmp_path / "12")            # no state file in it
        assert c.all_steps() == [3] and c.latest_step() == 3
        assert torch.equal(c.restore()["w"], torch.ones(2))


def test_warm_start_restores_the_latest_into_like(tmp_path):
    with tckpt.Checkpointer(str(tmp_path)) as c:
        for s in (4, 9):
            c.save(s, {"w": torch.full((3,), float(s))})
    state, step = tckpt.warm_start(
        str(tmp_path), like={"w": torch.zeros(3, dtype=torch.float64)})
    assert step == 9 and state["w"].dtype == torch.float64
    assert torch.equal(state["w"], torch.full((3,), 9.0, dtype=torch.float64))
    state, step = tckpt.warm_start(str(tmp_path), like=None, step=4)
    assert step == 4 and torch.equal(state["w"], torch.full((3,), 4.0))


def test_a_failed_background_write_raises_at_the_wait(tmp_path,
                                                      monkeypatch):
    def broken(obj, f):
        raise OSError("disk full")
    c = tckpt.Checkpointer(str(tmp_path))
    monkeypatch.setattr(tckpt.torch, "save", broken)
    c.save(1, {"w": torch.ones(1)}, wait=False)
    with pytest.raises(OSError, match="disk full"):
        c.wait_until_finished()
    assert c.all_steps() == [] and os.listdir(tmp_path) == []
