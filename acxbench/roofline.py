"""The yardstick's peaks and bounds: frozen copies of ``chip_smoke.py``'s
``PEAK_FLOPS`` and ``PEAK_BYTES`` (chip_smoke.py:460-462), ``bound_ms``
(:1770) and ``decode_bytes`` (:1860), as of commit 165c2cd. They live here
so that no later change to the program can move the yardstick.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
rates, no sparsity); dtypes are named by string so this module needs no
torch.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound_ms(flops, nbytes, dtype="bfloat16"):
    """The least time (ms) the chip could take for ``flops`` operations
    and ``nbytes`` bytes moved, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def decode_bytes(live, B, int8, paged, max_pages=0, hkv=12, hq=12,
                 head_dim=64):
    """Bytes a decode call at W = 1 must move (GPT-2's 12 heads unless
    told otherwise): the live K/V rows of the ``hkv`` groups (int8 codes
    and their f32 scales, or bf16), q and the output of the ``hq`` query
    heads, pos, and for the paged form the table."""
    return (live * hkv * head_dim * (1 if int8 else 2) * 2
            + (live * hkv * 4 * 2 if int8 else 0)
            + 2 * B * hq * head_dim * 2 + B * 4
            + (B * max_pages * 4 if paged else 0))
