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
  (offset T−S) only when S == T: causal calls with S != T raise unless the
  caller passes ``q_offset``;
* ``q_offset`` (the Pallas kernel has none) places query row i at sequence
  position ``q_offset + i``: under the causal mask it sees key t iff
  ``t <= q_offset + i``, so a context-parallel rank attends its shard of
  the queries against the whole sequence's keys, and key tiles wholly
  above its shifted diagonal are skipped;
* K/V are not repeated per query head: the kernel indexes KV head
  ``h // (H/KV)``;
* S and T need not be multiples of the tile: the kernel masks the edge.

The kernel has two bodies, chosen before launch by ``path_for`` (which the
CUDA side mirrors): ``"mma"``, the tensor cores through ``mma.sync``, for
bf16 at head_dim up to 128 on 16-byte aligned rows, with P applied as a bf16
hi + lo pair so that it keeps f32 accuracy; and ``"simt"``, f32 FMA on the
CUDA cores, for every other call (f32, head_dim 144-256, misaligned views).
A failed launch raises; it is never retried on the other body.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.no_backward import refuse_grad
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH = {"simt": 0, "mma": 1}
MMA_MAX_HD = 128


def path_for(dtype: torch.dtype, hd: int, strides, ptrs) -> str:
    """The body a launch takes: ``"mma"`` for bf16 with ``hd`` a multiple
    of 16 up to 128 when each of q, k and v (``strides``: their four
    strides in elements; ``ptrs``: their addresses) has a contiguous last
    dimension, its other strides multiples of 16 bytes and its base 16-byte
    aligned, so that every row suits 16-byte ``cp.async`` copies; else
    ``"simt"``.  ``mma_path`` in ``csrc/flash_attention.cu`` is the same
    rule."""
    item = dtype.itemsize
    if dtype != torch.bfloat16 or hd % 16 or hd > MMA_MAX_HD:
        return "simt"
    for st, ptr in zip(strides, ptrs):
        if st[-1] != 1 or ptr % 16 or any(x * item % 16 for x in st[:-1]):
            return "simt"
    return "mma"


def _check(q, k, v, causal: bool, softcap: float, q_offset=None) -> None:
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
    if causal and S != T and q_offset is None:
        raise ValueError(f"causal attention with S={S} != T={T}: the kernel "
                         "counts query and key positions both from 0 unless "
                         "q_offset is given")
    if q_offset is not None and (not isinstance(q_offset, int)
                                 or q_offset < 0):
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd} must be a multiple of 16 in [16, 256]")


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        softcap: float = 0.0, q_offset=None):
    """Plain version of the kernel: ``ref.attention_ref`` (f32 scores,
    softmax and PV product, output in q's dtype) on the inputs the kernel
    takes.  Causal calls without ``q_offset`` have S == T, where its T−S
    mask offset is 0, so the mask counts from 0 on both axes as the
    kernel's does; with ``q_offset`` query row i sees key t iff
    ``t <= q_offset + i``."""
    _check(q, k, v, causal, softcap, q_offset)
    if not causal or q_offset is None:
        return attention_ref(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qh = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qh, k.float()) / math.sqrt(hd)
    qpos = q_offset + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, :] <= qpos[:, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    o = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, dim=-1), v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    if lib.fa_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fa_forward.argtypes = ([ptr] * 4 + [i32] * 8 + [i64] * 12
                                   + [i32, i32, ctypes.c_float, i32, ptr])
        lib.fa_forward.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0,
                    q_offset=None, device="cuda"):
    """q [B,S,H,hd], k/v [B,T,KV,hd] → [B,S,H,hd].

    ``q_offset`` (an int, 0 when not given) is the sequence position of
    query row 0 under the causal mask; a causal call with S != T must pass
    it.  Launches that pass it are also counted by offset
    (``launches_by_offset``).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``flash_attention_ref``;
    CUDA tensors launch the kernel on the current stream, with no fallback,
    on the body ``path_for`` names.  Under autograd, on inputs that require
    grad, it raises ``NoBackwardKernelError`` on either device.
    """
    refuse_grad("K2 (flash attention)", "attention", q, k, v)
    dev = resolve_device(device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    _check(q, k, v, causal, softcap, q_offset)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last (head_dim) dimension must be contiguous")
    path = path_for(q.dtype, q.shape[3], (q.stride(), k.stride(), v.stride()),
                    (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    o = run_body(q, k, v, causal=causal, path=path, q_offset=q_offset or 0)
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    if q_offset is not None:
        by_offset = flash_attention.launches_by_offset
        by_offset[q_offset] = by_offset.get(q_offset, 0) + 1
    return o


def run_body(q, k, v, *, causal: bool, path: str, q_offset: int = 0):
    """Launches the named body on CUDA tensors that ``flash_attention`` has
    checked, and counts nothing.  ``"simt"`` runs any input; ``"mma"``
    where ``path_for`` does not give it is refused by the kernel's entry.
    The wrapper goes through here; ``chip_smoke.py`` and the card's tests
    call it to hold the two bodies against each other."""
    lib = _lib()
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    err = lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], q.device.index, B, S, T, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), q_offset, 1.0 / math.sqrt(hd), _PATH[path],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed ({path} "
                           f"body): {lib.fa_error_string(err).decode()}")
    return o


flash_attention.launches = 0
flash_attention.launches_by_path = {"mma": 0, "simt": 0}
flash_attention.launches_by_offset = {}
