"""Gradient compression: int8 quantization with error feedback.

Port of ``repro.runtime.compress``.  Each gradient is quantized to int8
with a per-tensor scale after adding the residual the last quantization
left, and the new residual is carried to the next step, so the compounded
error stays about one quantum instead of growing with the steps (EF-SGD).
``torch.round``, like ``jnp.round``, rounds half to even, so the port's
int8 values and residuals equal the reference's bit for bit.

``compressed_psum`` is the all-reduce itself over a process group of
ranks: quantize with one shared scale → int32 sum → dequantize (the wire
moves one byte a gradient).  ``make_compression_hook`` is a ``grad_hook``
for ``make_train_step`` that quantizes and dequantizes each gradient (what
such an all-reduce would deliver), its residuals carried in
``residuals_ref['value']``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.sharding import comm


def compress_ef_int8(g, residual):
    """Quantize (g + residual) to int8 with a per-tensor scale.
    Returns (q, scale, new_residual)."""
    gf = g.float() + residual
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_psum(x, group, residual=None):
    """int8 error-feedback sum of ``x`` over ``group``'s ranks (None: one
    rank).  Returns (the sum in f32, this rank's new residual).

    Every rank quantizes with one SHARED scale, the all-reduce MAX of the
    ranks' ``max|x + residual|``, over 127 plus 1e-12, so that the int32
    sum of the int8 values reconstructs exactly: Σᵢ qᵢ·s == (Σᵢ qᵢ)·s.
    Only each rank's quantization loses precision, and that loss is the
    residual carried to the next call."""
    if residual is None:
        residual = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float() + residual
    scale = comm.all_reduce(xf.abs().max(), group, "max") / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_res = xf - q.float() * scale
    total = comm.all_reduce(q.to(torch.int32), group)
    return total.float() * scale, new_res


def init_residuals(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def make_compression_hook(residuals_ref: Dict[str, Any]):
    """grad_hook for make_train_step: quantize+dequantize each gradient with
    error feedback; the residual dict lives in ``residuals_ref['value']``
    (None before the first step)."""
    @torch.no_grad()
    def hook(grads):
        res = residuals_ref["value"]
        if res is None:
            res = init_residuals(grads)
        out, new_res = {}, {}
        for n, g in grads.items():
            q, scale, new_res[n] = compress_ef_int8(g, res[n])
            out[n] = decompress_int8(q, scale)
        residuals_ref["value"] = new_res
        return out
    return hook
