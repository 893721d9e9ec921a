"""Weight reads for the model blocks (the JAX package's ``ops/wquant.py``).

Every matmul weight is read through :func:`wread`, so a checkpoint with
int8 weight-only quantization (``name`` holding int8 codes and
``name + "_scale"`` one f32 scale per output channel) and a plain one run
the same model code.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def wread(lp: Dict[str, Any], name: str, dtype) -> torch.Tensor:
    """Weight ``name`` of layer params ``lp`` in compute ``dtype``,
    dequantized when a ``name + "_scale"`` companion is present. The
    product is taken in f32 before the cast: a bf16 scale would add about
    0.4% error on top of the int8 rounding."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        return w.to(dtype)
    return (w.float() * s).to(dtype)
