"""The one generator: the same seed gives the same traffic, another seed
other tokens over the same sizes in the same order."""

import numpy as np
import pytest

from acxbench.traffic import ServeTraffic, quantile_lengths, zipf_tokens

CHAT = {"pool": 64, "requests_per_call": 16,
        "prompt": {"dist": "lognormal", "median": 192, "sigma": 0.6,
                   "min": 32, "max": 512},
        "output": {"dist": "uniform", "min": 2, "max": 8}}


def _calls(seed, n=3):
    t = ServeTraffic(CHAT, 50257, seed)
    return [t.call() for _ in range(n)]


def test_same_seed_same_traffic():
    a, b = _calls(3000000011), _calls(3000000011)
    for ca, cb in zip(a, b):
        for (pa, na), (pb, nb) in zip(ca, cb):
            assert na == nb and np.array_equal(pa, pb)


def test_other_seed_same_sizes_same_order_other_tokens():
    a, b = ServeTraffic(CHAT, 50257, 1), ServeTraffic(CHAT, 50257, 2)
    assert np.array_equal(a.prompt_lens, b.prompt_lens)
    assert np.array_equal(a.out_lens, b.out_lens)
    assert len(set(a.prompt_lens[:16].tolist())) > 1
    ca, cb = a.call(), b.call()
    assert [(len(p), n) for p, n in ca] == [(len(p), n) for p, n in cb]
    assert not np.array_equal(ca[0][0], cb[0][0])


@pytest.mark.parametrize("spec", [
    {"dist": "exponential", "mean": 337.99, "min": 4, "max": 1024},
    {"dist": "lognormal", "median": 640, "sigma": 0.7, "min": 128,
     "max": 3072},
    {"dist": "loguniform", "min": 2048, "max": 8000},
    {"dist": "uniform", "min": 2, "max": 8}])
def test_quantile_lengths(spec):
    q = quantile_lengths(spec, 1024)
    assert q.min() >= spec["min"] and q.max() <= spec["max"]
    assert np.all(np.diff(q) >= 0)
    if spec["dist"] == "lognormal":
        assert abs(np.median(q) - spec["median"]) <= 2
    if spec["dist"] == "exponential":
        # The law's mean over [min, max]: min + mean - width * e^-w/(1-e^-w)
        w = (spec["max"] - spec["min"]) / spec["mean"]
        want = (spec["min"] + spec["mean"]
                - (spec["max"] - spec["min"]) / np.expm1(w))
        assert abs(q.mean() - want) <= 1
    if spec["dist"] == "uniform":
        assert set(q.tolist()) == set(range(spec["min"], spec["max"] + 1))


def test_zipf_tokens():
    a = zipf_tokens(20000, 50257, 7)
    assert np.array_equal(a, zipf_tokens(20000, 50257, 7))
    assert not np.array_equal(a, zipf_tokens(20000, 50257, 8))
    assert a.dtype == np.uint16 and a.max() < 50257
    counts = np.sort(np.bincount(a, minlength=50257))[::-1]
    assert counts[0] > 20 * counts[1000]
