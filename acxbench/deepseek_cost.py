"""Operations and bytes of the work of the DeepSeek-V2 family's decode
kernels (``mpi_acx_torch/ops/mla.py``, ``ops/moe_experts.py``), from
shapes and the program's own routing counters, and the device time of
those kernels picked out of a traced span by name.

The kernels are Triton's, named in the trace as their functions are:
``_mla_decode_split_kernel`` and ``_mla_decode_combine_kernel`` (the
absorbed decode attention), ``_moe_experts_gate_up_kernel`` and
``_moe_experts_down_kernel`` (the routed experts). Inside a captured
decode step they are tied to their graph's launch, which lies in the
benchmark's ``decode_step`` span.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from acxbench import flops

MLA_DECODE = "mla_decode"
MOE_EXPERTS = "moe_experts"


def named_device_ms(tr, span: str, name: str) -> float:
    """Device ms of the operations launched inside ``span`` whose kernel
    name holds ``name``."""
    named = np.array([name in n for n in tr.op_names], dtype=bool)
    m = tr.inside(span) & named
    return float((tr.op_end[m] - tr.op_start[m]).sum()) / 1e6


def config_of(art, configs: Path):
    """The DeepSeek-V2 configuration file under ``configs`` whose shapes
    the run's ``art.dims`` are, or None."""
    for path in sorted(Path(configs).glob("*.json")):
        cfg = json.loads(path.read_text())
        if cfg.get("family") == "deepseek_v2" and flops.dims(cfg) == art.dims:
            return cfg
    return None


def mla_decode_cost(live: int, B: int, heads: int, kv_lora: int,
                    rope: int):
    """(operations, bytes) of one layer's absorbed decode attention over
    ``live`` cached rows summed over the B slots: each live row of
    ``kv_lora + rope`` bf16 values read once for every head, the latent
    queries read and the latent outputs written; QK over the whole row
    and PV over its first ``kv_lora``."""
    row = kv_lora + rope
    return (2 * heads * live * (row + kv_lora),
            live * row * 2 + B * heads * (row + kv_lora) * 2)


def moe_cost(touched: int, pairs: int, tokens: int, d: int, expert: int):
    """(operations, bytes) of routed-expert work: ``touched`` experts'
    three bf16 products of ``d`` x ``expert`` read once each, the
    ``tokens`` rows of the input read and of the output written in bf16;
    three products for each of the ``pairs``."""
    return (pairs * 3 * 2 * d * expert,
            touched * 3 * d * expert * 2 + tokens * d * 2 * 2)


def traced_rounds(art):
    """(experts touched, pairs routed, decode steps) summed over the MoE
    layers and over the whole decode rounds among the traced window's
    first steps (``art.calls``' round counters, ``chunk`` steps a round;
    a round the trace cut short is left out), or None where the program
    keeps no such counters."""
    n_steps = art.trace.count("decode_step")
    touched = pairs = steps = 0
    for call in art.calls:
        rc = getattr(call["out"], "round_counters", None)
        if not rc:
            return None
        rc = np.asarray(rc, dtype=np.int64)
        for prev, cur in zip(rc[:-1], rc[1:]):
            if steps + art.chunk > n_steps:
                return touched, pairs, steps
            diff = (cur - prev).sum(axis=0)
            touched += int(diff[0])
            pairs += int(diff[1])
            steps += art.chunk
    return touched, pairs, steps
