"""Grouped (per-expert) GEMM on Hopper: the wrapper of ``csrc/moe_gemm.cu``
and its plain PyTorch version.

Port of ``repro.kernels.moe_gemm`` (the Pallas kernel launched at
``moe_gemm.py:49``): ``x [E,M,K] @ w [E,K,N] → [E,M,N]`` with an f32
accumulator and the output in x's dtype.  Block sizes go through ``fit``
(``moe_gemm.py:41-45``, the same rule as K1's), so one variant names the
same tile in both packages.  The kernel's tile is K1's, with the expert as
a third grid dimension, and so is its shared memory per block
(``matmul.smem_bytes``).

The kernel has K1's two bodies, chosen before launch by ``path_for`` (which
the CUDA side mirrors): ``"mma"``, the tensor cores through ``mma.sync``
fed by a ``cp.async`` ring (``csrc/mma_tile.cuh``; f32 as three TF32
passes, within f32 rounding of the plain product), for tiles in multiples
of 16 on operands aligned in every expert; and ``"simt"``
(``csrc/gemm_tile.cuh``), IEEE f32 FMA on the CUDA cores, for every other
tile.  A failed launch raises; it is never retried on the other body.  A
CUDA call goes through the thin launch path (``kernels/launch.py``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  A tile whose shared memory exceeds what one
block may use raises before launch on either device, naming the bytes, so
automatic error repair sees the same error on the CPU as on the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels import matmul
from repro_torch.kernels.launch import Entry, names_cuda, raw_stream
from repro_torch.kernels.matmul import MAX_TILE, fit, smem_bytes
from repro_torch.kernels.ref import grouped_matmul_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH = {"simt": 0, "mma": 1}
_ENTRY = Entry("moe_gemm", "gmm_launch", "gmm_error_string", "=4Q16q")


@functools.lru_cache(maxsize=1024)
def _tile(x_shape, w_shape, dtype, w_dtype, block_m: int, block_n: int,
          block_k: int):
    """The tile fitted to (M, N, K); raises on what the kernel does not
    take (shared with the plain version, so CPU runs reject what the card
    would).  Cached: a call repeats its shapes, and the checks cost a
    short launch's host time."""
    if len(x_shape) != 3 or len(w_shape) != 3 or x_shape[0] != w_shape[0] \
            or x_shape[2] != w_shape[1]:
        raise ValueError(f"expected x [E,M,K] and w [E,K,N], got "
                         f"{tuple(x_shape)} and {tuple(w_shape)}")
    if dtype not in _DTYPE_CODE or w_dtype != dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{dtype} and {w_dtype}")
    _, M, K = x_shape
    bm, bn, bk = fit(block_m, M), fit(block_n, w_shape[2]), fit(block_k, K)
    if max(bm, bn, bk) > MAX_TILE:
        raise ValueError(f"tile {bm}x{bn}x{bk} above {MAX_TILE}")
    need = smem_bytes(bm, bn, bk, dtype.itemsize)
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"grouped matmul tile {bm}x{bn}x{bk} ({dtype}) needs {need} "
            f"bytes of shared memory per block, above the "
            f"{hw.SMEM_PER_BLOCK} an H100 block may use")
    return bm, bn, bk


def path_for(dtype: torch.dtype, bm: int, bn: int, bk: int, x_strides,
             w_strides, ptrs=(0, 0)) -> str:
    """The body a launch of the fitted tile (bm, bn, bk) takes: K1's rule
    (``matmul.path_for``) on one expert's operands, x [M,K] and w [K,N],
    and, for ``"mma"``, both expert strides in multiples of 16 bytes, so
    that every expert's operands are as aligned as the first's.
    ``x_strides`` and ``w_strides`` are the (expert, row, column) strides
    in elements, ``ptrs`` the addresses.  ``gmm_path`` in
    ``csrc/moe_gemm.cu`` is the same rule."""
    sx_e, sx_m, sx_k = x_strides
    sw_e, sw_k, sw_n = w_strides
    if sx_e * dtype.itemsize % 16 or sw_e * dtype.itemsize % 16:
        return "simt"
    return matmul.path_for(dtype, bm, bn, bk, (sx_m, sx_k, sw_k, sw_n),
                           ptrs)


def run_body(x, w, tile, path: str):
    """Launches the named body on CUDA tensors that ``grouped_matmul`` has
    checked, at the fitted ``tile``, and counts nothing.  ``"simt"`` runs
    any input; ``"mma"`` where ``path_for`` does not give it is refused by
    the kernel's entry.  The wrapper goes through here; ``chip_smoke.py``
    and the card's tests call it to hold the two bodies against each
    other."""
    E, M, K = x.shape
    N = w.shape[2]
    index = x.get_device()
    o = x.new_empty((E, M, N))
    err = _ENTRY(x.data_ptr(), w.data_ptr(), o.data_ptr(), raw_stream(index),
                 _DTYPE_CODE[x.dtype], index, _PATH[path], E, M, N, K,
                 *tile, *x.stride(), *w.stride())
    if err:
        bm, bn, bk = tile
        raise RuntimeError(
            f"grouped matmul kernel launch failed ({path} body, tile "
            f"{bm}x{bn}x{bk}, {smem_bytes(bm, bn, bk, x.element_size())} "
            f"bytes of shared memory): {_ENTRY.error_string(err)}")
    return o


def grouped_matmul(x, w, *, block_m: int = 128, block_n: int = 128,
                   block_k: int = 128, device="cuda"):
    """x [E,M,K] @ w [E,K,N] → [E,M,N] in x's dtype, f32 accumulator.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, with no fallback, on
    the body ``path_for`` names.  x and w may be strided views.  The plain
    version is ``ref.grouped_matmul_ref``.
    """
    if not (x.is_cuda and names_cuda(device)):
        dev = resolve_device(device)
        for name, t in (("x", x), ("w", w)):
            if t.device.type != dev.type:
                raise ValueError(f"{name} lies on {t.device}, not on {dev}")
        _tile(x.shape, w.shape, x.dtype, w.dtype, block_m, block_n, block_k)
        return grouped_matmul_ref(x, w)
    if w.get_device() != x.get_device():
        raise ValueError(f"x and w must lie on one device, not {x.device} "
                         f"and {w.device}")
    tile = _tile(x.shape, w.shape, x.dtype, w.dtype, block_m, block_n,
                 block_k)
    path = path_for(x.dtype, *tile, x.stride(), w.stride(),
                    (x.data_ptr(), w.data_ptr()))
    o = run_body(x, w, tile, path)
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_path[path] += 1
    return o


grouped_matmul.launches = 0
grouped_matmul.launches_by_path = {"mma": 0, "simt": 0}
