"""The thin launch path of the K3 and K5 wrappers (``reduce_sum``,
``grouped_matmul``).

A wrapper's Python and ctypes work on a CUDA call is host time that a short
kernel's launch cannot hide.  This path keeps it to what the launch needs:

* ``names_cuda`` caches what a ``device`` argument names, and a CUDA tensor
  on a CUDA request skips ``resolve_device``: a CUDA tensor already proves
  a GPU is present (CPU tensors and mismatches still go through it);
* ``raw_stream`` reads the current stream's handle without building a
  ``torch.cuda.Stream`` object;
* ``Entry`` binds a C entry that takes all of a launch's arguments as one
  packed struct of 8-byte fields (``struct.Struct.pack``), loaded and bound
  once, at the first call, so ctypes converts one argument, not twenty.

A failed launch still raises with CUDA's error string; nothing here falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def names_cuda(device) -> bool:
    """Whether ``device`` (a string or ``torch.device``) names a CUDA
    device."""
    return torch.device(device).type == "cuda"


def raw_stream(index: int) -> int:
    """The handle of CUDA device ``index``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


class Entry:
    """``int <name>(const void* packed)`` of ``csrc/<source>.cu``, called
    with the fields packed by ``fmt`` (``struct`` format of 8-byte fields);
    returns the cudaError_t.  Built and bound at the first call."""

    def __init__(self, source: str, name: str, error_name: str, fmt: str):
        self.source, self.name, self.error_name = source, name, error_name
        self.pack = struct.Struct(fmt).pack
        self.fn = None

    def __call__(self, *fields) -> int:
        fn = self.fn or self._bind()
        return fn(self.pack(*fields))

    def _bind(self):
        lib = build.library(self.source)
        fn = getattr(lib, self.name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, self.error_name)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self.error_string = lambda code: err(code).decode()
        self.fn = fn
        return fn
