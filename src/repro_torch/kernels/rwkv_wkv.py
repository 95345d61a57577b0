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

The kernel's grid is (head, batch, column slice): a block takes VB value
columns of one (batch, head), G = K / 8 lanes a column (``geometry``), and
walks the sequence one stage of ``chunk`` steps at a time.  On a CPU tensor the wrapper computes the plain version;
on a CUDA tensor it launches the kernel through the thin launch path
(``kernels/launch.py``) or raises.  A ``chunk`` whose stage exceeds the
shared memory of a block raises before launch on either device, naming the
bytes.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import hw
from repro_torch.device import resolve_device
from repro_torch.kernels.launch import Entry, names_cuda, raw_stream
from repro_torch.kernels.no_backward import refuse_grad
from repro_torch.kernels.ref import wkv_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = Entry("rwkv_wkv", "wkv_launch", "wkv_error_string", "=8Q21q")
HEAD_SIZES = (16, 32, 64, 128)      # K
ROWS = 8                            # state rows a lane keeps
MAX_THREADS = 256                   # a block's lanes, G * VB (csrc)
TARGET_BLOCKS = 2 * hw.SMS          # about two blocks an SM


@functools.lru_cache(maxsize=None)
def geometry(BH: int, K: int, V: int):
    """(G, VB, slices) of a launch over B·H = ``BH`` heads: G = K / 8 lanes
    a column, VB columns a block, ``slices`` = ceil(V / VB) blocks a head.

    VB is a multiple of ``unit`` = max(32 / G, 8) columns, so every warp
    is whole and a bf16 slice of v is a 16-byte row: the multiple nearest
    V / ceil(TARGET_BLOCKS / BH), so that the grid holds about two blocks
    an SM where V has that many units, and at most MAX_THREADS / G."""
    G = K // ROWS
    unit = max(32 // G, 8)
    want = -(-TARGET_BLOCKS // BH)                      # slices a head
    VB = unit * min(max(1, round(V / (unit * want))),
                    MAX_THREADS // G // unit, -(-V // unit))
    return G, VB, -(-V // VB)


def smem_bytes(chunk: int, K: int, VB: int, itemsize: int) -> int:
    """Shared memory one block allocates, one stage: exp(lw) [chunk, K] in
    f32, r and k [chunk, K] and v [chunk, VB] in the input type
    (``stage_bytes`` in ``csrc/rwkv_wkv.cu``)."""
    return chunk * (K * (4 + 2 * itemsize) + VB * itemsize)


@functools.lru_cache(maxsize=1024)
def _launch_shape(r_shape, k_shape, v_shape, lw_shape, u_shape, dtype,
                  k_dtype, v_dtype, u_dtype, lw_dtype, chunk: int):
    """(B, S, H, K, V, staged chunk, VB); raises on what the kernel
    does not take (shared with the plain version, so CPU runs reject what
    the card would).  Cached: a call repeats its shapes, and the checks
    cost a short launch's host time."""
    if len(r_shape) != 4 or k_shape != r_shape or lw_shape != r_shape:
        raise ValueError(f"expected r/k/lw [B,S,H,K] of one shape, got "
                         f"{tuple(r_shape)}, {tuple(k_shape)}, "
                         f"{tuple(lw_shape)}")
    B, S, H, K = r_shape
    if len(v_shape) != 4 or tuple(v_shape[:3]) != (B, S, H):
        raise ValueError(f"v {tuple(v_shape)} does not match r "
                         f"{tuple(r_shape)}")
    if tuple(u_shape) != (H, K):
        raise ValueError(f"u {tuple(u_shape)} is not [H, K] = [{H}, {K}]")
    if dtype not in _DTYPE_CODE or any(d != dtype for d in (k_dtype, v_dtype,
                                                            u_dtype)):
        raise TypeError(f"r/k/v/u must share float32 or bfloat16, got "
                        f"{dtype}, {k_dtype}, {v_dtype}, {u_dtype}")
    if lw_dtype != torch.float32:
        raise TypeError(f"lw (the log decay) must be float32, got {lw_dtype}")
    if K not in HEAD_SIZES:
        raise ValueError(f"head size K={K} not in {HEAD_SIZES}")
    V = v_shape[3]
    if not 1 <= V <= 1024:
        raise ValueError(f"value size V={V} must be in [1, 1024]")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    c = min(chunk, S)
    _, VB, _ = geometry(B * H, K, V)
    item = dtype.itemsize
    need = smem_bytes(c, K, VB, item)
    if need > hw.SMEM_PER_BLOCK:
        raise RuntimeError(
            f"wkv chunk {c} (K {K}, V {V}, {dtype}) needs {need} bytes of "
            f"shared memory per block, above the {hw.SMEM_PER_BLOCK} an H100 "
            f"block may use")
    return B, S, H, K, V, c, VB


def _check(r, k, v, lw, u, chunk: int):
    return _launch_shape(r.shape, k.shape, v.shape, lw.shape, u.shape,
                         r.dtype, k.dtype, v.dtype, u.dtype, lw.dtype, chunk)


def wkv_plain(r, k, v, lw, u, *, chunk: int = 64):
    """Plain version of the kernel: the sequential recurrence
    (``ref.wkv_ref``, f32 throughout) with ``o`` in r's dtype.  ``chunk``
    only stages the kernel's loads, so it does not change the result."""
    _check(r, k, v, lw, u, chunk)
    o, state = wkv_ref(r, k, v, lw, u)
    return o.to(r.dtype), state


def _launch(r, k, v, lw, u, shape):
    B, S, H, K, V, c, VB = shape
    index = r.get_device()
    u = u.contiguous()
    o = r.new_empty((B, S, H, V))
    state = r.new_empty((B, H, K, V), dtype=torch.float32)
    err = _ENTRY(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), o.data_ptr(), state.data_ptr(),
                 raw_stream(index), _DTYPE_CODE[r.dtype], index, B, S, H, K,
                 V, c, VB, *r.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *lw.stride()[:3])
    if err:
        raise RuntimeError(
            f"wkv kernel launch failed (chunk {c}, "
            f"{smem_bytes(c, K, VB, r.element_size())} bytes of shared "
            f"memory): {_ENTRY.error_string(err)}")
    return o, state


def wkv(r, k, v, lw, u, *, chunk: int = 64, device="cuda"):
    """r/k/lw [B,S,H,K], v [B,S,H,V], u [H,K] → (o [B,S,H,V] in r's
    dtype, final state [B,H,K,V] f32).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``wkv_plain``; CUDA tensors
    launch the kernel on the current stream, with no fallback.  r/k/v/lw
    may be strided views whose last dimension is contiguous.  Under
    autograd, on inputs that require grad, it raises
    ``NoBackwardKernelError`` on either device.
    """
    tensors = (r, k, v, lw, u)
    refuse_grad("K6 (WKV6)", "rwkv_wkv", *tensors)
    if not (r.is_cuda and names_cuda(device)):
        dev = resolve_device(device)
        for name, t in zip("r k v lw u".split(), tensors):
            if t.device.type != dev.type:
                raise ValueError(f"{name} lies on {t.device}, not on {dev}")
        return wkv_plain(r, k, v, lw, u, chunk=chunk)
    index = r.get_device()
    if any(t.get_device() != index for t in tensors):
        raise ValueError("r, k, v, lw and u must lie on one device, not "
                         + ", ".join(str(t.device) for t in tensors))
    if any(t.stride(-1) != 1 for t in tensors[:4]):
        raise ValueError("the last (head) dimension must be contiguous")
    out = _launch(r, k, v, lw, u, _check(r, k, v, lw, u, chunk))
    wkv.launches += 1
    return out


wkv.launches = 0
