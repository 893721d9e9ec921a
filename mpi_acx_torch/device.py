"""Where the port's entry points run.

Entry points take an explicit ``device``; ``None`` means the GPU. A GPU
request on a machine without one raises instead of drifting onto the CPU,
so a run that was meant for the card can never quietly measure the host.
Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available (pass "
            "device='cpu' to run on the host)")
    return dev


def on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """True iff tensor ``t`` lies on ``dev`` (an index-less ``cuda``
    matches any card)."""
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)
