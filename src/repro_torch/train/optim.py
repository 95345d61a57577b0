"""AdamW with f32 state, global-norm clipping and a warmup + cosine schedule.

Port of ``repro.train.optim``.  A parameter tree here is a flat dict name →
tensor (``train.steps.model_params``: the model's own parameters, names as
in its state dict); the moments mirror it in f32.  ``apply_update`` is
functional: it returns new parameter and moment tensors and changes none
of its inputs, so a step that raises part way leaves the state as it was
(``train.steps`` commits the new parameters only once all are computed).

Weight decay follows the JAX package's rule as it acts there, where layers
are stacked ``[L, ...]``: it decays ``p.ndim >= 2`` of the stacked leaf,
that is every parameter of a layer (norm scales and biases included) and
the top-level parameters of rank 2 or more.  The port keeps each layer's
parameters unstacked (``layers.3.ln1`` is ``(d,)``), so ``decays`` counts
the layer index in the name as the stack's axis (ROADMAP.md queue 3).
``state_axes`` gives the moments their parameters' logical axes; under
a sharded train step (``train.steps``: weights at rest, or
``grad_shardings``) the moments are each rank's pieces of those layouts
(``init_state``'s ``layouts``) and the clipping norm is the global one,
handed to ``apply_update``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or an integer tensor), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: Dict[str, torch.Tensor], layouts=None
               ) -> Dict[str, Any]:
    """Zero moments (f32) and step; with ``layouts`` (name →
    ``sharding.Layout``) each moment is this rank's piece of its
    parameter's layout."""
    def zeros():
        return {n: torch.zeros(p.shape if layouts is None
                               else layouts[n].local_shape(p.shape),
                               dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaves summed in
    the dict's order, as the reference sums its flattened leaves)."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter ``name``: its rank in the
    reference's stacked layout (a layer index in the name adds the stack's
    axis) is 2 or more."""
    stacked = any(part.isdigit() for part in name.split("."))
    return p.dim() + stacked >= 2


def _update_leaf(cfg: AdamWConfig, name, p, g, mu, nu, scale, lr, b1c, b2c):
    """(new p, new mu, new nu) of one leaf; its inputs are left as they are."""
    g = g.float() * scale
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
    delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
    if decays(name, p):
        delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), mu, nu


def state_axes(param_axes_tree) -> Dict[str, Any]:
    """Logical axes for the optimizer state (mirrors params)."""
    return {"mu": param_axes_tree, "nu": param_axes_tree, "step": ()}


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params, grads, state, grad_norm=None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                            Dict[str, torch.Tensor]]:
    """(new params, new state, {"grad_norm", "lr"}); functional.
    ``grad_norm``: the norm to clip by, when ``grads`` are pieces of a
    sharded tree (default: ``global_norm(grads)``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    new_p, mu, nu = {}, {}, {}
    for name, p in params.items():
        new_p[name], mu[name], nu[name] = _update_leaf(
            cfg, name, p.detach(), grads[name], state["mu"][name],
            state["nu"][name], scale, lr, b1c, b2c)
    return new_p, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
