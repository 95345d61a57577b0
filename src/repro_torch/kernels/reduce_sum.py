"""Blocked sum of a 1-D array on Hopper: the wrapper of ``csrc/reduce_sum.cu``
and its plain PyTorch version.

Port of ``repro.kernels.suites.pallas_lib.reduce_sum_pallas`` (the Pallas
kernel launched at ``pallas_lib.py:101``): ``x`` is cut into blocks of
``block`` elements (fitted to a divisor of its length, as ``_fit`` does),
each block summed in f32, the block sums added in f32, and the total
returned in x's dtype as a 0-d tensor, as the Pallas wrapper returns
element 0 of its ``[1]`` output (``keepdim=True`` returns that ``[1]``
tensor itself).

The kernel sums in one launch: the last CUDA block to finish, picked by a
ticket counter, adds the blocks' partials in index order
(``csrc/reduce_sum.cu``; a CUDA block sums up to 16 small blocks).
No atomic adds a value, so the same values give a bit-identical result on
every call and at any address.  The ticket and the partials live in a
workspace kept per (device, stream) (``workspace``).  A CUDA call goes
through the thin launch path (``kernels/launch.py``).  On a CPU tensor the
wrapper computes the plain version; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.launch import Entry, names_cuda, raw_stream
from repro_torch.kernels.matmul import fit

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = Entry("reduce_sum", "reduce_sum_launch", "reduce_sum_error_string",
               "=4Q4q")
# (device index, stream handle) -> int32 [1 + capacity]: the ticket, then
# the partials (as f32 bits)
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


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


def workspace(key, n_blocks: int, device) -> torch.Tensor:
    """The scratch of the launches keyed ``key`` (device index, stream
    handle): an int32 tensor of at least ``1 + n_blocks`` elements, its
    element 0 the ticket.  Allocated zeroed, and grown (never shrunk) when
    a launch needs more partials; every launch leaves the ticket at 0.  One
    workspace per stream, so two streams never share a ticket."""
    ws = _workspaces.get(key)
    if ws is None or ws.numel() <= n_blocks:
        size = 1 + max(n_blocks, 2 * (ws.numel() - 1) if ws is not None
                       else 255)
        ws = _workspaces[key] = torch.zeros(size, dtype=torch.int32,
                                            device=device)
    return ws


def reduce_sum(x, *, block: int = 4096, keepdim: bool = False,
               device="cuda"):
    """sum(x) with an f32 accumulator, as a 0-d tensor in x's dtype (``[1]``
    with ``keepdim``).

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensor's.  CPU tensors take ``reduce_sum_plain``; CUDA
    tensors launch the kernel on the current stream, with no fallback.
    """
    if not (x.is_cuda and names_cuda(device)):
        dev = resolve_device(device)
        if x.device.type != dev.type:
            raise ValueError(f"x lies on {x.device}, not on {dev}")
        out = reduce_sum_plain(x, block=block)
        return out.reshape(1) if keepdim else out
    _check(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    blk = fit(block, n)
    index = x.get_device()
    stream = raw_stream(index)
    ws = workspace((index, stream), n // blk, x.device)
    out = x.new_empty((1,) if keepdim else ())
    err = _ENTRY(x.data_ptr(), out.data_ptr(), ws.data_ptr(), stream,
                 _DTYPE_CODE[x.dtype], index, n, blk)
    if err:
        raise RuntimeError(f"reduce_sum kernel launch failed (n {n}, block "
                           f"{blk}): {_ENTRY.error_string(err)}")
    reduce_sum.launches += 1
    return out


reduce_sum.launches = 0
