"""The refusal of a forward-only kernel under autograd.

K2, K6 and K7 launch through ctypes into tensors made by ``torch.empty``:
their outputs carry no ``grad_fn``, so under autograd nothing would flow
back through them into their inputs, and a training step would run on
with silently wrong gradients.  The JAX package has no backward kernel
either (a ``jax.grad`` through its Pallas flash kernel raises in Pallas's
jvp rule), so its train step runs the plain path at every site.  The port
refuses such a call by name, before it looks at the device, so the CPU
(where the wrappers compute the plain version) refuses as the card does.
"""
from __future__ import annotations

import torch


class NoBackwardKernelError(RuntimeError):
    """A forward-only kernel was called where autograd needs its gradient."""


def refuse_grad(kernel: str, site: str, *tensors) -> None:
    """Raises ``NoBackwardKernelError`` when grad mode is on and any of
    ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NoBackwardKernelError(
            f"{kernel} at the {site!r} site was called under autograd on "
            "inputs that require grad: neither this port nor the JAX package "
            "has a backward kernel for it, and its output would carry no "
            f"gradient; train with no impl installed at {site!r} (the plain "
            "path), or call it under torch.no_grad()")
