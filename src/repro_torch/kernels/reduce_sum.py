"""Blocked sum of a 1-D array on Hopper: the wrapper of ``csrc/reduce_sum.cu``
and its plain PyTorch version.

Port of ``repro.kernels.suites.pallas_lib.reduce_sum_pallas`` (the Pallas
kernel launched at ``pallas_lib.py:101``): ``x`` is cut into blocks of
``block`` elements (fitted to a divisor of its length, as ``_fit`` does),
each block summed in f32, the block sums added in f32, and the total
returned in x's dtype as a 0-d tensor, as the Pallas wrapper returns
element 0 of its ``[1]`` output.

The kernel sums in two passes with no atomics (``csrc/reduce_sum.cu``), so
the same input gives a bit-identical result on every call.  On a CPU tensor
the wrapper computes the plain version; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.matmul import fit

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"expected a non-empty 1-D array, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")


def reduce_sum_plain(x, *, block: int = 4096):
    """Plain version of the kernel: the f32 sums of the fitted blocks, then
    their f32 sum, in x's dtype (0-d)."""
    _check(x)
    blk = fit(block, x.shape[0])
    return x.float().reshape(-1, blk).sum(dim=1).sum().to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("reduce_sum")
    if lib.reduce_sum_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.reduce_sum_forward.argtypes = [ptr] * 3 + [i32] * 2 + [i64] * 2 \
            + [ptr]
        lib.reduce_sum_forward.restype = ctypes.c_int
        lib.reduce_sum_error_string.argtypes = [i32]
        lib.reduce_sum_error_string.restype = ctypes.c_char_p
    return lib


def reduce_sum(x, *, block: int = 4096, device="cuda"):
    """sum(x) with an f32 accumulator, as a 0-d tensor in x's dtype.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensor's.  CPU tensors take ``reduce_sum_plain``; CUDA
    tensors launch the two passes on the current stream, with no fallback.
    """
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(f"x lies on {x.device}, not on {dev}")
    _check(x)
    if dev.type == "cpu":
        return reduce_sum_plain(x, block=block)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    blk = fit(block, n)
    lib = _lib()
    partial = torch.empty(n // blk, dtype=torch.float32, device=x.device)
    out = torch.empty(1, dtype=x.dtype, device=x.device)
    err = lib.reduce_sum_forward(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[x.dtype], x.device.index, n, blk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"reduce_sum kernel launch failed (n {n}, block {blk}): "
            + lib.reduce_sum_error_string(err).decode())
    reduce_sum.launches += 1
    return out[0]


reduce_sum.launches = 0
