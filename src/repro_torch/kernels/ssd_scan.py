"""Mamba-2 SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``
and its plain PyTorch version.

Port of ``repro.kernels.ssd_scan`` (the Pallas kernel launched at
``ssd_scan.py:73``).  Per (batch, head), chunk by chunk, with the state
[P, N] kept on chip:

    la = cumsum(−exp(a_log)·dt) within the chunk,  u = dt·xh
    y_t = Σ_{s≤t} (C_t·B_s) exp(la_t − la_s) u_s + exp(la_t) C_t·S
    S  ← exp(la_end) S + Σ_s exp(la_end − la_s) u_s ⊗ B_s

Model-site signature: xh [B,S,H,P], dt [B,S,H] (f32, after softplus),
a_log [H], B_t/C_t [B,S,N] → (y [B,S,H,P] in xh's dtype, final state
[B,H,P,N] in f32).  The preamble the JAX wrapper computes outside its
``pallas_call`` (``u``, ``la``; ``ssd_scan.py:69-70``) is fused into the
kernel.

Where the two differ on purpose:

* the Pallas wrapper returns ``y`` only (``ssd_scan.py:91``), so the model
  fills in a state of zeros (``ssm.py:84-87``); this one returns the state;
* any S: the last chunk is masked, where the Pallas wrapper shrinks
  ``chunk`` until it divides S (``ssd_scan.py:59-61``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 32          # query rows of the decay-weighted C·Bᵀ tile (csrc)
MAX_P = 128        # the kernel's thread grid covers at most 128 columns


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory one block allocates: la, exp(la), exp(la_end − la)
    [chunk]; B and C [chunk, N+1]; u [chunk, P]; a [32, chunk+1] tile of
    the decay-weighted C·Bᵀ; the state [P, N+1]; all f32.  The tile keeps
    it linear in ``chunk``: 72,576 bytes at the hymba shape (chunk 128,
    P 64, N 16), 140,672 at chunk 256."""
    return 4 * (3 * chunk + 2 * chunk * (N + 1) + chunk * P
                + ROWS * (chunk + 1) + P * (N + 1))


def _check(xh, dt, a_log, B_t, C_t, chunk: int) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if xh.dim() != 4:
        raise ValueError(f"expected xh [B,S,H,P], got {tuple(xh.shape)}")
    Bb, S, H, P = xh.shape
    if tuple(dt.shape) != (Bb, S, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log "
                         f"{tuple(a_log.shape)} do not match xh "
                         f"{tuple(xh.shape)}")
    if B_t.dim() != 3 or tuple(B_t.shape[:2]) != (Bb, S) \
            or C_t.shape != B_t.shape:
        raise ValueError(f"B_t {tuple(B_t.shape)} / C_t {tuple(C_t.shape)} "
                         f"are not [B, S, N] of xh {tuple(xh.shape)}")
    if xh.dtype not in _DTYPE_CODE or B_t.dtype != xh.dtype \
            or C_t.dtype != xh.dtype:
        raise TypeError(f"xh/B_t/C_t must share float32 or bfloat16, got "
                        f"{xh.dtype}, {B_t.dtype}, {C_t.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"dt must be float32, got {dt.dtype}")
    if a_log.dtype not in _DTYPE_CODE:
        raise TypeError(f"a_log must be float32 or bfloat16, got "
                        f"{a_log.dtype}")
    if P % 16 or not 16 <= P <= MAX_P:
        raise ValueError(f"head size P={P} must be a multiple of 16 in "
                         f"[16, {MAX_P}]")
    N = B_t.shape[2]
    if not 1 <= N <= 128:
        raise ValueError(f"state size N={N} must be in [1, 128]")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    need = smem_bytes(min(chunk, S), P, N)
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"ssd chunk {min(chunk, S)} (P {P}, N {N}) needs {need} bytes of "
            f"shared memory per block, above the {hw.SMEM_PER_BLOCK} an H100 "
            f"block may use")


def ssd_plain(xh, dt, a_log, B_t, C_t, *, chunk: int = 128):
    """Plain version of the kernel: the model's exact chunked SSD
    (``models.ssm._ssd_chunked``, f32 throughout) over chunks of
    ``min(chunk, S)``, the last one masked as the kernel masks it: S is
    padded to a whole chunk with dt = 0, where a step neither decays the
    state (exp 0 = 1) nor adds to it (u = 0), and the pad rows of y are
    dropped.  y in xh's dtype, the state in f32."""
    from repro_torch.models.ssm import _ssd_chunked
    _check(xh, dt, a_log, B_t, C_t, chunk)
    S = xh.shape[1]
    c = min(chunk, S)
    pad = -S % c
    if pad:
        xh, B_t, C_t = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in (xh, B_t, C_t))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = _ssd_chunked(xh, dt, a_log, B_t, C_t, c, use_impl=False)
    return y[:, :S], state


def _lib() -> ctypes.CDLL:
    lib = build.library("ssd_scan")
    if lib.ssd_forward.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_forward.argtypes = ([ptr] * 7 + [i32] * 8 + [i64] * 9
                                    + [ptr])
        lib.ssd_forward.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [i32]
        lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def ssd(xh, dt, a_log, B_t, C_t, *, chunk: int = 128, device="cuda"):
    """xh [B,S,H,P], dt [B,S,H] f32, a_log [H], B_t/C_t [B,S,N] →
    (y [B,S,H,P] in xh's dtype, final state [B,H,P,N] f32).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``ssd_plain``; CUDA tensors
    launch the kernel on the current stream, with no fallback.  xh, dt,
    B_t and C_t may be strided views whose last dimension is contiguous
    (the model's B_t and C_t are two halves of one projection).
    """
    dev = resolve_device(device)
    for name, t in (("xh", xh), ("dt", dt), ("a_log", a_log), ("B_t", B_t),
                    ("C_t", C_t)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, not on {dev}")
    _check(xh, dt, a_log, B_t, C_t, chunk)
    if dev.type == "cpu":
        return ssd_plain(xh, dt, a_log, B_t, C_t, chunk=chunk)
    if any(t.device != xh.device for t in (dt, a_log, B_t, C_t)):
        raise ValueError("xh, dt, a_log, B_t and C_t must lie on one device")
    if any(t.stride(-1) != 1 for t in (xh, dt, B_t, C_t)):
        raise ValueError("the last dimension of xh, dt, B_t and C_t must be "
                         "contiguous")
    lib = _lib()
    Bb, S, H, P = xh.shape
    N = B_t.shape[2]
    c = min(chunk, S)
    a_log = a_log.float().contiguous()        # [H]: the kernel reads f32
    y = torch.empty((Bb, S, H, P), dtype=xh.dtype, device=xh.device)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=xh.device)
    err = lib.ssd_forward(
        xh.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B_t.data_ptr(),
        C_t.data_ptr(), y.data_ptr(), state.data_ptr(),
        _DTYPE_CODE[xh.dtype], xh.device.index, Bb, S, H, P, N, c,
        *xh.stride()[:3], *dt.stride()[:2], *B_t.stride()[:2],
        *C_t.stride()[:2],
        torch.cuda.current_stream(xh.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"ssd kernel launch failed (chunk {c}, {smem_bytes(c, P, N)} "
            f"bytes of shared memory): " + lib.ssd_error_string(err).decode())
    ssd.launches += 1
    return y, state


ssd.launches = 0
