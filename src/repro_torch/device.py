"""Device selection shared by the port's entry points, and the lock that
keeps CUDA-graph capture apart from other threads' device work.

Every entry point runs on the card unless the caller asks for the CPU: a
``device`` argument defaults to ``"cuda"``, and without a GPU that default
raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import threading

import torch

# Held by ``BatchedServer`` while it captures its CUDA graphs and by a
# ``ServeAutotuner`` cycle (campaign, FE checks, guard probes).  A capture
# runs in CUDA's global mode, where a CUDA call from another thread breaks
# the capture or the call; re-entrant, so a thread that holds it may
# capture.
DEVICE_LOCK = threading.RLock()


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
