"""The port's profiling helpers (mpi_acx_torch/profiling.py) held against
the JAX package's ``profiling.py``.

``StepTimer.summary()`` is pure arithmetic over the sample list, so it is
held **equal** to JAX's on the same samples (nearest-rank percentiles, no
interpolation). ``trace`` writes a ``torch.profiler`` Chrome trace into
its logdir, and an ``annotate`` name is found in it. The card's trace is
read by ``chip_smoke.py`` phase 5e.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from mpi_acx_tpu import profiling as jprof
from mpi_acx_torch import profiling as tprof

SAMPLES = {
    "empty": [],
    "one": [0.25],
    "ramp": [float(i) for i in range(1, 11)],
    "reversed": [float(i) for i in range(10, 0, -1)],
    "random": list(np.random.default_rng(0).exponential(0.01, 37)),
    "hundred": list(np.random.default_rng(1).uniform(0.1, 0.2, 100)),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_summary_equals_jax(name):
    jt, tt = jprof.StepTimer(), tprof.StepTimer()
    jt.samples = list(SAMPLES[name])
    tt.samples = list(SAMPLES[name])
    assert tt.summary() == jt.summary()


def test_steps_time_the_work_and_dump(tmp_path):
    t = tprof.StepTimer()
    x = torch.arange(1024.0)
    for _ in range(5):
        with t.step() as region:
            region.sync((x * 2 + 1, {"loss": x.sum()}))
    s = t.summary()
    assert s["steps"] == 5
    assert 0 < s["min_s"] <= s["p50_s"] <= s["p90_s"] <= s["p99_s"] \
        <= s["max_s"]
    out = t.dump(str(tmp_path / "steps.json"), extra={"tag": "test"})
    loaded = json.loads((tmp_path / "steps.json").read_text())
    assert loaded["tag"] == "test" and loaded["samples"] == t.samples
    assert out["steps"] == 5
    jt = jprof.StepTimer()
    jt.samples = list(t.samples)
    assert {k: loaded[k] for k in jt.summary()} == jt.summary()
    t.reset()
    assert t.summary() == {"steps": 0} == jprof.StepTimer().summary()


def test_a_region_without_sync_raises_as_jax():
    for mod in (jprof, tprof):
        t = mod.StepTimer()
        with pytest.raises(RuntimeError, match="without sync"):
            with t.step():
                pass
        assert t.samples == []


def test_sync_needs_nothing_for_cpu_values():
    assert not tprof._sync(torch.ones(3))
    assert not tprof._sync({"a": [torch.ones(2), 3.0], "b": None})
    assert not tprof._sync(1.5)


def test_trace_writes_a_file_holding_the_annotation(tmp_path):
    logdir = tmp_path / "prof"
    with tprof.trace(str(logdir)):
        with tprof.annotate("train_step"):
            x = torch.ones(64, 64)
            (x @ x).sum().item()
    files = [f for f in glob.glob(os.path.join(logdir, "**", "*"),
                                  recursive=True) if os.path.isfile(f)]
    assert len(files) == 1
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any(ev.get("name") == "train_step" for ev in events)
