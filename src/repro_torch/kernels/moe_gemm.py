"""Grouped (per-expert) GEMM on Hopper: the wrapper of ``csrc/moe_gemm.cu``
and its plain PyTorch version.

Port of ``repro.kernels.moe_gemm`` (the Pallas kernel launched at
``moe_gemm.py:49``): ``x [E,M,K] @ w [E,K,N] → [E,M,N]`` with an f32
accumulator and the output in x's dtype.  Block sizes go through ``fit``
(``moe_gemm.py:41-45``, the same rule as K1's), so one variant names the
same tile in both packages.  The kernel's tile is K1's
(``csrc/gemm_tile.cuh``), with the expert as a third grid dimension, and so
is its shared memory per block (``matmul.smem_bytes``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  A tile whose shared memory exceeds what one
block may use raises before launch on either device, naming the bytes, so
automatic error repair sees the same error on the CPU as on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.matmul import MAX_TILE, fit, smem_bytes
from repro_torch.kernels.ref import grouped_matmul_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _tile(x, w, block_m: int, block_n: int, block_k: int):
    """The tile fitted to (M, N, K); raises on what the kernel does not
    take (shared with the plain version, so CPU runs reject what the card
    would)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected x [E,M,K] and w [E,K,N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    _, M, K = x.shape
    bm, bn, bk = fit(block_m, M), fit(block_n, w.shape[2]), fit(block_k, K)
    if max(bm, bn, bk) > MAX_TILE:
        raise ValueError(f"tile {bm}x{bn}x{bk} above {MAX_TILE}")
    need = smem_bytes(bm, bn, bk, x.element_size())
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"grouped matmul tile {bm}x{bn}x{bk} ({x.dtype}) needs {need} "
            f"bytes of shared memory per block, above the "
            f"{hw.SMEM_PER_BLOCK} an H100 block may use")
    return bm, bn, bk


def _lib() -> ctypes.CDLL:
    lib = build.library("moe_gemm")
    if lib.gmm_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gmm_forward.argtypes = [ptr] * 3 + [i32] * 9 + [i64] * 6 + [ptr]
        lib.gmm_forward.restype = ctypes.c_int
        lib.gmm_error_string.argtypes = [i32]
        lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def grouped_matmul(x, w, *, block_m: int = 128, block_n: int = 128,
                   block_k: int = 128, device="cuda"):
    """x [E,M,K] @ w [E,K,N] → [E,M,N] in x's dtype, f32 accumulator.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, with no fallback.  x
    and w may be strided views.  The plain version is
    ``ref.grouped_matmul_ref``.
    """
    dev = resolve_device(device)
    for name, t in (("x", x), ("w", w)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    bm, bn, bk = _tile(x, w, block_m, block_n, block_k)
    if dev.type == "cpu":
        return grouped_matmul_ref(x, w)
    if w.device != x.device:
        raise ValueError("x and w must lie on one device")
    lib = _lib()
    E, M, K = x.shape
    N = w.shape[2]
    o = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    err = lib.gmm_forward(
        x.data_ptr(), w.data_ptr(), o.data_ptr(), _DTYPE_CODE[x.dtype],
        x.device.index, E, M, N, K, bm, bn, bk, *x.stride(), *w.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"grouped matmul kernel launch failed (tile {bm}x{bn}x{bk}, "
            f"{smem_bytes(bm, bn, bk, x.element_size())} bytes of shared "
            f"memory): {lib.gmm_error_string(err).decode()}")
    grouped_matmul.launches += 1
    return o


grouped_matmul.launches = 0
