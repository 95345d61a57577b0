"""Tiled GEMM with a fused epilogue on Hopper: the wrapper of
``csrc/matmul.cu`` and its plain PyTorch version.

Port of ``repro.kernels.suites.pallas_lib.matmul_pallas`` (the Pallas kernel
launched at ``pallas_lib.py:70``): ``O = epilogue(A @ B [, C])`` with an f32
accumulator, epilogues ``none``, ``alpha_beta`` (αAB + βC) and ``relu``, the
output in A's dtype.  Block sizes go through ``fit`` as in the Pallas
wrapper, so one variant names the same tile in both packages.

The kernel has two bodies, chosen before launch by ``path_for`` (which the
CUDA side mirrors): ``"mma"``, the tensor cores through ``mma.sync`` fed by
a ``cp.async`` ring (f32 as three TF32 passes, within f32 rounding of the
plain product), for tiles in multiples of 16 on aligned operands; and
``"simt"``, IEEE f32 FMA on the CUDA cores, for every other tile.  A failed
launch raises; it is never retried on the other path.

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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPILOGUE = {"none": 0, "alpha_beta": 1, "relu": 2}
_PATH = {"simt": 0, "mma": 1}
SUB = 128          # the kernel's largest sub-tile side (csrc/matmul.cu)
MAX_TILE = 256


def fit(b: int, dim: int) -> int:
    """The largest tile ≤ ``b`` that divides ``dim`` (``pallas_lib._fit``)."""
    b = max(1, min(b, dim))
    while dim % b:
        b -= 1
    return b


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory one block of the kernel allocates for a (bm, bn, bk)
    tile: A[min(bm,128), bk] and B[bk, min(bn,128)] in the input dtype."""
    return (min(bm, SUB) + min(bn, SUB)) * bk * itemsize


def _operand_ok(ptr: int, s_mn: int, s_k: int, item: int) -> bool:
    """A 16-byte-aligned operand contiguous along k or along m/n, its other
    stride a multiple of 16 bytes: what 16-byte ``cp.async`` copies need."""
    if ptr % 16:
        return False
    if s_k == 1:
        return s_mn * item % 16 == 0
    return s_mn == 1 and s_k * item % 16 == 0


def path_for(dtype: torch.dtype, bm: int, bn: int, bk: int, strides,
             ptrs=(0, 0)) -> str:
    """The body a launch of the fitted tile (bm, bn, bk) takes: ``"mma"``
    when every side is a multiple of 16 and both operands suit ``cp.async``
    (``strides`` = A's (m, k) and B's (k, n) strides in elements, ``ptrs``
    their addresses), else ``"simt"``.  ``mma_tile::mma_path`` in
    ``csrc/mma_tile.cuh`` is the same rule."""
    item = dtype.itemsize
    sa_m, sa_k, sb_k, sb_n = strides
    if bm % 16 or bn % 16 or bk % 16:
        return "simt"
    if not (_operand_ok(ptrs[0], sa_m, sa_k, item)
            and _operand_ok(ptrs[1], sb_n, sb_k, item)):
        return "simt"
    return "mma"


def _check(a, b, c, epilogue: str, bm: int, bn: int, bk: int) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected A [M,K] and B [K,N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"A and B must share float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if epilogue not in _EPILOGUE:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "alpha_beta":
        if c is None or tuple(c.shape) != (a.shape[0], b.shape[1]):
            raise ValueError("the alpha_beta epilogue needs C [M,N]")
        if c.dtype != torch.float32:
            raise TypeError(f"C must be float32, got {c.dtype}")
    need = smem_bytes(bm, bn, bk, a.element_size())
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"matmul tile {bm}x{bn}x{bk} ({a.dtype}) needs {need} bytes of "
            f"shared memory per block, above the {hw.SMEM_PER_BLOCK} an "
            f"H100 block may use")


def matmul_ref(a, b, c=None, *, epilogue: str = "none", alpha: float = 1.0,
               beta: float = 1.0):
    """Plain version of the kernel: f32 product, the epilogue in f32, the
    result in A's dtype (as ``_mm_kernel`` computes it)."""
    acc = a.float() @ b.float()
    if epilogue == "alpha_beta":
        acc = alpha * acc + beta * c.float()
    elif epilogue == "relu":
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(a.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("matmul")
    if lib.mm_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mm_forward.argtypes = ([ptr] * 4 + [i32] * 8 + [i64] * 6
                                   + [i32, ctypes.c_float, ctypes.c_float,
                                      i32, ptr])
        lib.mm_forward.restype = ctypes.c_int
        lib.mm_error_string.argtypes = [i32]
        lib.mm_error_string.restype = ctypes.c_char_p
    return lib


def matmul(a, b, c=None, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128, epilogue: str = "none", alpha: float = 1.0,
           beta: float = 1.0, device="cuda"):
    """O = epilogue(A @ B [, C]) with an f32 accumulator; O in A's dtype.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``matmul_ref``; CUDA tensors
    launch the kernel on the current stream, with no fallback, on the body
    ``path_for`` names.  A and B may be strided views (a transpose needs no
    copy).
    """
    dev = resolve_device(device)
    for name, t in (("A", a), ("B", b), ("C", c)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    M, K = a.shape
    N = b.shape[1] if b.dim() == 2 else 0
    bm, bn, bk = fit(block_m, M), fit(block_n, N), fit(block_k, K)
    if max(bm, bn, bk) > MAX_TILE:
        raise ValueError(f"tile {bm}x{bn}x{bk} above {MAX_TILE}")
    _check(a, b, c, epilogue, bm, bn, bk)
    if dev.type == "cpu":
        return matmul_ref(a, b, c, epilogue=epilogue, alpha=alpha, beta=beta)
    if a.device != b.device or (c is not None and c.device != a.device):
        raise ValueError("A, B and C must lie on one device")
    path = path_for(a.dtype, bm, bn, bk, (*a.stride(), *b.stride()),
                    (a.data_ptr(), b.data_ptr()))
    lib = _lib()
    o = torch.empty((M, N), dtype=a.dtype, device=a.device)
    use_c = epilogue == "alpha_beta"
    err = lib.mm_forward(
        a.data_ptr(), b.data_ptr(), c.data_ptr() if use_c else None,
        o.data_ptr(), _DTYPE_CODE[a.dtype], a.device.index, M, N, K,
        bm, bn, bk, *a.stride(), *b.stride(),
        *(c.stride() if use_c else (0, 0)), _EPILOGUE[epilogue],
        float(alpha), float(beta), _PATH[path],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"matmul kernel launch failed ({path} path, tile {bm}x{bn}x{bk}, "
            f"{smem_bytes(bm, bn, bk, a.element_size())} bytes of shared "
            f"memory): {lib.mm_error_string(err).decode()}")
    matmul.launches += 1
    matmul.launches_by_path[path] += 1
    return o


matmul.launches = 0
matmul.launches_by_path = {"mma": 0, "simt": 0}
