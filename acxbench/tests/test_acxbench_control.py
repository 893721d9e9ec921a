"""The control on the chip, at a size a test run holds: the float8
reference in the program's place fails a serve cell's check and a train
cell's, where the program passes. (The readings at the cells' own sizes,
over three seeds and more, are ``control.py``'s; PERF.md keeps them.)"""

import pytest

from acxbench import control, harness


@pytest.mark.chip
def test_serve_control_fails(cuda):
    bench = harness.Bench()
    limit = bench.workload("gpt2-124m.serve-chat")["limits"]["max_logit_gap"]
    r = control.readings(bench, "gpt2-124m.serve-chat", 3000000101, 2.0,
                         None, cuda)
    assert r["max_logit_gap"] <= limit < r["control_gap"]


@pytest.mark.chip
def test_train_control_fails(cuda):
    bench = harness.Bench()
    limits = bench.workload("gpt2-124m.train-32k")["limits"]
    r = control.readings(bench, "gpt2-124m.train-32k", 3000000102, 0.0,
                         None, cuda)
    assert all(r["program"][k] <= v for k, v in limits.items())
    assert any(r["control"][k] > v for k, v in limits.items())
