"""RWKV6 WKV recurrence on Hopper: the wrapper of ``csrc/rwkv_wkv.cu`` and
its plain PyTorch version.

Port of ``repro.kernels.rwkv_wkv`` (the Pallas kernel launched at
``rwkv_wkv.py:65``): per (batch, head)

    o_t = r_t · (S + u ⊙ k_t ⊗ v_t),   S ← diag(exp lw_t) · S + k_t ⊗ v_t

with the state S [K, V] kept on chip for the whole sequence.  Model-site
signature: r/k/lw [B,S,H,K], v [B,S,H,V], u [H,K] → (o [B,S,H,V] in r's
dtype, final state [B,H,K,V] in f32).

Where the two differ on purpose:

* the Pallas wrapper returns ``o`` only, though its docstring promises the
  final state (``rwkv_wkv.py:53``), so the model fills in a state of zeros
  (``ssm.py:227-231``); this one returns the state, so a prefill through the
  kernel hands decode the state it continues from;
* any S: ``chunk`` is the number of time steps staged in shared memory per
  load and the last stage is masked, where the Pallas wrapper shrinks
  ``chunk`` until it divides S (``rwkv_wkv.py:56-58``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  A ``chunk`` whose stage exceeds the shared
memory of a block raises before launch on either device, naming the bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import wkv_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64, 128)      # K: the kernel's state rows per thread


def smem_bytes(chunk: int, K: int, V: int) -> int:
    """Shared memory one block allocates: r, k, exp(lw) [chunk, K], v
    [chunk, V], the per-step bonus r·(u⊙k) [chunk] and u [K], in f32."""
    return 4 * (chunk * (3 * K + V + 1) + K)


def _check(r, k, v, lw, u, chunk: int) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if r.dim() != 4 or k.shape != r.shape or lw.shape != r.shape:
        raise ValueError(f"expected r/k/lw [B,S,H,K] of one shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(lw.shape)}")
    B, S, H, K = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v {tuple(v.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} is not [H, K] = [{H}, {K}]")
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype for t in (k, v, u)):
        raise TypeError(f"r/k/v/u must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if lw.dtype != torch.float32:
        raise TypeError(f"lw (the log decay) must be float32, got {lw.dtype}")
    if K not in HEAD_SIZES:
        raise ValueError(f"head size K={K} not in {HEAD_SIZES}")
    V = v.shape[3]
    if not 1 <= V <= 1024:
        raise ValueError(f"value size V={V} must be in [1, 1024] (one "
                         "thread per value column)")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    need = smem_bytes(min(chunk, S), K, V)
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"wkv chunk {min(chunk, S)} (K {K}, V {V}) needs {need} bytes of "
            f"shared memory per block, above the {hw.SMEM_PER_BLOCK} an H100 "
            f"block may use")


def wkv_plain(r, k, v, lw, u, *, chunk: int = 64):
    """Plain version of the kernel: the sequential recurrence
    (``ref.wkv_ref``, f32 throughout) with ``o`` in r's dtype.  ``chunk``
    only stages the kernel's loads, so it does not change the result."""
    _check(r, k, v, lw, u, chunk)
    o, state = wkv_ref(r, k, v, lw, u)
    return o.to(r.dtype), state


def _lib() -> ctypes.CDLL:
    lib = build.library("rwkv_wkv")
    if lib.wkv_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wkv_forward.argtypes = ([ptr] * 7 + [i32] * 8 + [i64] * 12
                                    + [ptr])
        lib.wkv_forward.restype = ctypes.c_int
        lib.wkv_error_string.argtypes = [i32]
        lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def wkv(r, k, v, lw, u, *, chunk: int = 64, device="cuda"):
    """r/k/lw [B,S,H,K], v [B,S,H,V], u [H,K] → (o [B,S,H,V] in r's
    dtype, final state [B,H,K,V] f32).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``wkv_plain``; CUDA tensors
    launch the kernel on the current stream, with no fallback.  r/k/v/lw
    may be strided views whose last dimension is contiguous.
    """
    dev = resolve_device(device)
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    _check(r, k, v, lw, u, chunk)
    if dev.type == "cpu":
        return wkv_plain(r, k, v, lw, u, chunk=chunk)
    if any(t.device != r.device for t in (k, v, lw, u)):
        raise ValueError("r, k, v, lw and u must lie on one device")
    if any(t.stride(-1) != 1 for t in (r, k, v, lw)):
        raise ValueError("the last (head) dimension must be contiguous")
    lib = _lib()
    B, S, H, K = r.shape
    V = v.shape[3]
    u = u.contiguous()
    o = torch.empty((B, S, H, V), dtype=r.dtype, device=r.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    err = lib.wkv_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), o.data_ptr(), state.data_ptr(),
        _DTYPE_CODE[r.dtype], r.device.index, B, S, H, K, V, min(chunk, S),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *lw.stride()[:3],
        torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"wkv kernel launch failed (chunk {min(chunk, S)}, "
            f"{smem_bytes(min(chunk, S), K, V)} bytes of shared memory): "
            + lib.wkv_error_string(err).decode())
    wkv.launches += 1
    return o, state


wkv.launches = 0
