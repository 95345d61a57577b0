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

The kernel has two bodies, chosen before launch by ``path_for`` (which the
CUDA side mirrors): ``"mma"``, the tensor cores through ``mma.sync`` on a
grid over (head, batch, slice of PB columns of P) (``geometry``), bf16
with every f32 operand as a hi + lo pair and f32 as three TF32 passes;
and ``"simt"``, f32 FMA on the CUDA cores, one block a (batch, head), for
an xh off 16 bytes or a chunk whose ``mma`` stages do not fit a block.  A
failed launch raises; it is never retried on the other body.  A CUDA call
goes through the thin launch path (``kernels/launch.py``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  A chunk whose ``simt`` shared memory
exceeds a block's raises before launch on either device, naming the bytes.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels.launch import Entry, names_cuda, raw_stream
from repro_torch.kernels.no_backward import refuse_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH = {"simt": 0, "mma": 1}
_ENTRY = Entry("ssd_scan", "ssd_launch", "ssd_error_string", "=8Q19q")
ROWS = 32          # query rows of the simt body's C·Bᵀ tile (csrc)
MAX_P = 128        # the simt body's thread grid covers at most 128 columns
WIDTHS = (32, 16)  # the mma body's column slices, widest first
MIN_BLOCKS = 100   # the fewest blocks a wider slice must leave the grid


@functools.lru_cache(maxsize=None)
def geometry(B: int, H: int, P: int):
    """(PB, slices) of an ``mma`` launch: PB columns of P a block, P / PB
    blocks a (batch, head).  The widest slice that divides P and leaves
    the grid at least MIN_BLOCKS blocks (each block recomputes its chunk's
    C·Bᵀ, so wider is less work where the card stays full), else 16, the
    narrowest.  At hymba-1.5b's served B = 1 (H 50, P 64): slices of 32,
    100 blocks, twice the 50 of one block a head."""
    for PB in WIDTHS:
        if P % PB == 0 and B * H * (P // PB) >= MIN_BLOCKS:
            return PB, P // PB
    return WIDTHS[-1], P // WIDTHS[-1]


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory one ``simt`` block allocates: la, exp(la),
    exp(la_end − la) [chunk]; B and C [chunk, N+1]; u [chunk, P]; a [32,
    chunk+1] tile of the decay-weighted C·Bᵀ; the state [P, N+1]; all f32.
    The tile keeps it linear in ``chunk``: 72,576 bytes at the hymba shape
    (chunk 128, P 64, N 16), 140,672 at chunk 256."""
    return 4 * (3 * chunk + 2 * chunk * (N + 1) + chunk * P
                + ROWS * (chunk + 1) + P * (N + 1))


def mma_smem_bytes(chunk: int, PB: int, N: int, itemsize: int) -> int:
    """Shared memory one ``mma`` block allocates (``Layout`` in
    ``csrc/ssd_scan.cu``): two stages of the xh slice [CP, PB + E], B and
    C [CP, NK + E] (E = 16 bytes of the input type) and dt [CP] f32; la,
    exp(la) and dt·exp(la_end − la) [CP] f32; two f32 state buffers
    [PB, NK + 4] and, in bf16, their hi and lo halves [PB, NK + 8] each.
    CP is the chunk and NK the state size, each rounded up to 16.  45,056
    bytes at hymba's chunk 128 (bf16, PB 16, N 16)."""
    CP, NK, E = -(-chunk // 16) * 16, -(-N // 16) * 16, 16 // itemsize
    stage = CP * ((PB + E + 2 * (NK + E)) * itemsize + 4)
    return (2 * stage + 3 * CP * 4 + 2 * PB * (NK + 4) * 4
            + (4 * PB * (NK + 8) * 2 if itemsize == 2 else 0))


def path_for(dtype: torch.dtype, chunk: int, N: int, x_strides,
             x_ptr: int = 0) -> str:
    """The body a launch takes: ``"mma"`` where xh's address and its
    (batch, sequence, head) strides ``x_strides`` (in elements) are
    multiples of 16 bytes, since its slices are copied 16 bytes at a time,
    and the ``mma`` stages of ``chunk`` fit a block at the widest slice;
    else ``"simt"``.  B_t, C_t and dt take any view the wrapper accepts
    (the model's B_t and C_t, two halves of one projection, included).
    ``mma_path`` in ``csrc/ssd_scan.cu`` is the same rule."""
    item = dtype.itemsize
    if x_ptr % 16 or any(s * item % 16 for s in x_strides):
        return "simt"
    if mma_smem_bytes(chunk, WIDTHS[0], N, item) > hw.SMEM_PER_BLOCK:
        return "simt"
    return "mma"


@functools.lru_cache(maxsize=1024)
def _launch_shape(x_shape, dt_shape, a_shape, b_shape, c_shape, dtype,
                  dt_dtype, a_dtype, b_dtype, c_dtype, chunk: int):
    """(B, S, H, P, N, staged chunk); raises on what the kernel does not
    take (shared with the plain version, so CPU runs reject what the card
    would).  Cached: a call repeats its shapes, and the checks cost a
    short launch's host time."""
    if len(x_shape) != 4:
        raise ValueError(f"expected xh [B,S,H,P], got {tuple(x_shape)}")
    Bb, S, H, P = x_shape
    if tuple(dt_shape) != (Bb, S, H) or tuple(a_shape) != (H,):
        raise ValueError(f"dt {tuple(dt_shape)} / a_log {tuple(a_shape)} "
                         f"do not match xh {tuple(x_shape)}")
    if len(b_shape) != 3 or tuple(b_shape[:2]) != (Bb, S) \
            or c_shape != b_shape:
        raise ValueError(f"B_t {tuple(b_shape)} / C_t {tuple(c_shape)} "
                         f"are not [B, S, N] of xh {tuple(x_shape)}")
    if dtype not in _DTYPE_CODE or b_dtype != dtype or c_dtype != dtype:
        raise TypeError(f"xh/B_t/C_t must share float32 or bfloat16, got "
                        f"{dtype}, {b_dtype}, {c_dtype}")
    if dt_dtype != torch.float32:
        raise TypeError(f"dt must be float32, got {dt_dtype}")
    if a_dtype not in _DTYPE_CODE:
        raise TypeError(f"a_log must be float32 or bfloat16, got {a_dtype}")
    if P % 16 or not 16 <= P <= MAX_P:
        raise ValueError(f"head size P={P} must be a multiple of 16 in "
                         f"[16, {MAX_P}]")
    N = b_shape[2]
    if not 1 <= N <= 128:
        raise ValueError(f"state size N={N} must be in [1, 128]")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    c = min(chunk, S)
    need = smem_bytes(c, P, N)
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"ssd chunk {c} (P {P}, N {N}) needs {need} bytes of shared "
            f"memory per block, above the {hw.SMEM_PER_BLOCK} an H100 "
            f"block may use")
    return Bb, S, H, P, N, c


def _check(xh, dt, a_log, B_t, C_t, chunk: int):
    return _launch_shape(xh.shape, dt.shape, a_log.shape, B_t.shape,
                         C_t.shape, xh.dtype, dt.dtype, a_log.dtype,
                         B_t.dtype, C_t.dtype, chunk)


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


def run_body(xh, dt, a_log, B_t, C_t, *, chunk: int, path: str,
             width: int = 0):
    """Launches the named body on CUDA tensors that ``ssd`` has checked
    and counts nothing.  ``"simt"`` runs any input; ``"mma"`` where
    ``path_for`` does not give it is refused by the kernel's entry.
    ``width`` sets the ``mma`` body's column slice (16 or 32; default
    ``geometry``'s).  The wrapper goes through here; ``chip_smoke.py`` and
    the card's tests call it to hold the bodies against each other and to
    time the two slice widths."""
    return _launch(xh, dt, a_log, B_t, C_t,
                   _check(xh, dt, a_log, B_t, C_t, chunk), path, width)


def _launch(xh, dt, a_log, B_t, C_t, shape, path: str, width: int = 0):
    Bb, S, H, P, N, c = shape
    PB = width or geometry(Bb, H, P)[0]
    index = xh.get_device()
    if a_log.dtype != torch.float32 or not a_log.is_contiguous():
        a_log = a_log.float().contiguous()      # [H]: the kernel reads f32
    y = xh.new_empty((Bb, S, H, P))
    state = xh.new_empty((Bb, H, P, N), dtype=torch.float32)
    err = _ENTRY(xh.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 B_t.data_ptr(), C_t.data_ptr(), y.data_ptr(),
                 state.data_ptr(), raw_stream(index),
                 _DTYPE_CODE[xh.dtype], index, _PATH[path], Bb, S, H, P, N,
                 c, PB, *xh.stride()[:3], *dt.stride()[:2],
                 *B_t.stride()[:2], *C_t.stride()[:2])
    if err:
        need = (smem_bytes(c, P, N) if path == "simt" else
                mma_smem_bytes(c, PB, N, xh.element_size()))
        raise RuntimeError(
            f"ssd kernel launch failed ({path} body, chunk {c}, {need} "
            f"bytes of shared memory): {_ENTRY.error_string(err)}")
    return y, state


def ssd(xh, dt, a_log, B_t, C_t, *, chunk: int = 128, device="cuda"):
    """xh [B,S,H,P], dt [B,S,H] f32, a_log [H], B_t/C_t [B,S,N] →
    (y [B,S,H,P] in xh's dtype, final state [B,H,P,N] f32).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``ssd_plain``; CUDA tensors
    launch the kernel on the current stream, with no fallback, on the body
    ``path_for`` names.  xh, dt, B_t and C_t may be strided views whose
    last dimension is contiguous (the model's B_t and C_t are two halves
    of one projection).  Under autograd, on inputs that require grad, it
    raises ``NoBackwardKernelError`` on either device.
    """
    tensors = (xh, dt, a_log, B_t, C_t)
    refuse_grad("K7 (Mamba-2 SSD)", "ssm_chunk", *tensors)
    if not (xh.is_cuda and names_cuda(device)):
        dev = resolve_device(device)
        for name, t in zip(("xh", "dt", "a_log", "B_t", "C_t"), tensors):
            if t.device.type != dev.type:
                raise ValueError(f"{name} lies on {t.device}, not on {dev}")
        return ssd_plain(xh, dt, a_log, B_t, C_t, chunk=chunk)
    index = xh.get_device()
    if any(t.get_device() != index for t in tensors):
        raise ValueError("xh, dt, a_log, B_t and C_t must lie on one device,"
                         " not " + ", ".join(str(t.device) for t in tensors))
    if any(t.stride(-1) != 1 for t in (xh, dt, B_t, C_t)):
        raise ValueError("the last dimension of xh, dt, B_t and C_t must be "
                         "contiguous")
    shape = _check(xh, dt, a_log, B_t, C_t, chunk)
    path = path_for(xh.dtype, shape[5], shape[4], xh.stride()[:3],
                    xh.data_ptr())
    out = _launch(xh, dt, a_log, B_t, C_t, shape, path)
    ssd.launches += 1
    ssd.launches_by_path[path] += 1
    return out


ssd.launches = 0
ssd.launches_by_path = {"mma": 0, "simt": 0}
