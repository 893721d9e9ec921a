"""Pipeline parallelism over a 'pp' mesh axis: the GPipe schedule of the
JAX package's ``parallel/pipeline.py`` (``pipeline_forward``).

T = n_micro + n_stages - 1 ticks; stage s computes microbatch m at tick
t = s + m, and activations travel stage -> stage + 1 by ``ppermute``.
Autograd through the tick loop gives the backward pipeline. On the
one-device mesh of this port there is one stage and no bubble.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpi_acx_torch.parallel.collective import (axis_index, axis_size,
                                               ppermute, psum)


def _first(tree):
    """Drop the leading stage axis of every tensor in a (nested) dict."""
    return {k: _first(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def pipeline_forward(stage_fn: Callable, stage_params, xs, axis_name: str,
                     with_aux: bool = False):
    """Runs ``xs`` ([n_micro, micro_batch, ...]) through the pipeline and
    returns the last stage's outputs [n_micro, micro_batch, ...] on every
    stage (by psum).

    ``stage_params`` holds this stage's parameters under a leading stage
    axis of 1 (dropped here). ``stage_fn(params, x) -> y`` with
    ``y.shape == x.shape``.

    ``with_aux=True``: ``stage_fn`` returns ``(y, aux)``, aux a tuple of f32
    scalars (the MoE router losses), and the function returns ``(ys,
    aux_sum)``: this stage's aux summed over its valid ticks only, once
    per (layer of the stage, microbatch). Aux never travels between
    stages; the caller psums it over the axis."""
    n_stages = axis_size(axis_name)
    stage = axis_index(axis_name)
    n_micro = xs.shape[0]
    params = _first(stage_params)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]  # no wraparound

    from_left = torch.zeros_like(xs[0])
    ys, aux_sum = [], None
    for t in range(n_micro + n_stages - 1):
        x = xs[min(t, n_micro - 1)] if stage == 0 else from_left
        y = stage_fn(params, x)
        if with_aux:
            y, aux = y
            # Stage s computes microbatch t - s at tick t; the other ticks
            # are the bubble.
            if 0 <= t - stage < n_micro:
                aux_sum = aux if aux_sum is None else tuple(
                    a + b for a, b in zip(aux_sum, aux))
        from_left = ppermute(y, axis_name, fwd_perm)
        ys.append(y)
    # The last stage's valid outputs are those of ticks [n_stages-1, T).
    tail = torch.stack(ys[n_stages - 1:])
    contrib = tail if stage == n_stages - 1 else torch.zeros_like(tail)
    out = psum(contrib, axis_name)
    return (out, aux_sum) if with_aux else out
