"""Device selection shared by the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: a
``device`` argument defaults to ``"cuda"``, and without a GPU that default
raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no GPU
    is present, or names anything but a CUDA device or the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
