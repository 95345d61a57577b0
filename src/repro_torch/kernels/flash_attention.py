"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Port of ``repro.kernels.flash_attention`` (the Pallas kernel launched at
``flash_attention.py:82``).  Model-site signature: q ``[B,S,H,hd]``, k/v
``[B,T,KV,hd]`` (GQA) → ``[B,S,H,hd]`` in q's dtype.

Where the two differ on purpose:

* the Pallas wrapper drops ``softcap`` silently; here a non-zero softcap
  raises (glm4 uses 0);
* the causal mask counts query and key positions both from 0, as the Pallas
  kernel and ``attention_chunked`` do, which equals ``ref.attention_ref``
  (offset T−S) only when S == T: causal calls with S != T raise;
* K/V are not repeated per query head: the kernel indexes KV head
  ``h // (H/KV)``;
* S and T need not be multiples of the tile: the kernel masks the edge.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, causal: bool, softcap: float) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B,S,H,hd] and k/v [B,T,KV,hd]")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if softcap:
        raise NotImplementedError("the flash kernel does not implement "
                                  f"softcap (got {softcap})")
    if causal and S != T:
        raise ValueError(f"causal attention with S={S} != T={T}: the kernel "
                         "counts query and key positions both from 0")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd} must be a multiple of 16 in [16, 256]")


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        softcap: float = 0.0):
    """Plain version of the kernel: ``ref.attention_ref`` (f32 scores,
    softmax and PV product, output in q's dtype) on the inputs the kernel
    takes.  Causal calls have S == T, where its T−S mask offset is 0, so
    the mask counts from 0 on both axes as the kernel's does."""
    _check(q, k, v, causal, softcap)
    return attention_ref(q, k, v, causal=causal)


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    if lib.fa_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_forward.argtypes = ([ptr] * 4 + [i32] * 8 + [i64] * 12
                                   + [i32, ctypes.c_float, ptr])
        lib.fa_forward.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0,
                    device="cuda"):
    """q [B,S,H,hd], k/v [B,T,KV,hd] → [B,S,H,hd].

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``flash_attention_ref``;
    CUDA tensors launch the kernel on the current stream, with no fallback.
    """
    dev = resolve_device(device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    _check(q, k, v, causal, softcap)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last (head_dim) dimension must be contiguous")
    lib = _lib()
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    err = lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], q.device.index, B, S, T, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.fa_error_string(err).decode())
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
