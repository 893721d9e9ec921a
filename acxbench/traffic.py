"""The one traffic generator: every mix is a data file of parameters that
this module reads (a workload's ``traffic`` object).

Serving: a pool of ``pool`` requests whose prompt and output lengths are
the pool's evenly spaced quantiles of each length distribution, paired
and ordered by one fixed draw: every seed replays the same sizes in the
same order and draws only the prompt tokens (in a closed loop the order
decides which requests queue behind which, so a seeded order would
change the work from seed to seed). Calls of ``requests_per_call``
requests walk the order round the pool; with a pool of one call's size,
every call carries the same sizes in the same order.

Training: ``file_tokens`` tokens drawn from a Zipf law over the vocabulary (the
seed permutes which ids are frequent) into a uint16 token file.

Length distributions: ``{"dist": "exponential", "mean", "min", "max"}``
(the law of greatest entropy for a published mean, its lengths outside
[min, max] dropped, as a benchmark's filter drops them), ``{"dist":
"lognormal", "median", "sigma", "min", "max"}`` (clipped to [min, max]),
``{"dist": "loguniform", "min", "max"}``, ``{"dist": "uniform", "min",
"max"}`` (whole numbers, both ends included).
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the distribution,
    within [min, max]."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    dist = spec["dist"]
    if dist == "exponential":
        kept = -math.expm1(-(hi - lo) / spec["mean"])
        raw = lo - spec["mean"] * np.log1p(-q * kept)
    elif dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        raw = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif dist == "loguniform":
        raw = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif dist == "uniform":
        raw = lo + np.floor(q * (hi - lo + 1))
    else:
        raise ValueError(f"length distribution {dist!r}")
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


Request = Tuple[np.ndarray, int]          # (prompt tokens int32, n_new)


class ServeTraffic:
    """The seed's requests, call after call."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        pool = traffic["pool"]
        self.per_call = traffic["requests_per_call"]
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        order = np.random.default_rng(0)
        prompts = quantile_lengths(traffic["prompt"], pool)
        outs = quantile_lengths(traffic["output"], pool)
        self.prompt_lens = prompts[order.permutation(pool)]
        self.out_lens = outs[order.permutation(pool)]
        self.next_index = 0

    def call(self) -> List[Request]:
        """The next call's requests."""
        out = []
        for _ in range(self.per_call):
            i = self.next_index % len(self.prompt_lens)
            self.next_index += 1
            toks = self.rng.integers(0, self.vocab, int(self.prompt_lens[i]),
                                     dtype=np.int32)
            out.append((toks, int(self.out_lens[i])))
        return out


def zipf_tokens(n: int, vocab: int, seed: int, exponent: float = 1.1,
                offset: float = 2.7) -> np.ndarray:
    """``n`` token ids with p(rank r) proportional to (r + offset) ** -exponent
    (a Zipf-Mandelbrot law, as word frequencies follow); which id has
    which rank is the seed's permutation."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(vocab, dtype=np.float64)
    cdf = np.cumsum((ranks + offset) ** -exponent)
    cdf /= cdf[-1]
    drawn = np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1)
    return rng.permutation(vocab)[drawn].astype(np.uint16)
