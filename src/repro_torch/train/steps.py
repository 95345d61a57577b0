"""Step functions: train (grad accumulation, clipping, AdamW), prefill,
serve/decode.

Port of ``repro.train.steps``.  The port's model owns its parameters, so
the parameter tree a step takes is ``model_params(model)``, the model's own
tensors by name (sorted); the train step computes their gradients with
autograd, switching ``requires_grad`` on for the step only (serving keeps
building no graph), and commits the AdamW update into them once every new
tensor is computed: a step that raises part way leaves parameters and
moments as they were, as the reference's functional state does.  Prefill
and serve steps read the model's parameters and take none.

A step runs the plain path at every kernel site, as the reference's does:
no kernel has a backward, and K2, K6 and K7 refuse to run under grad
(``kernels.no_backward``).  Not ported: ``grad_shardings``, which waits for
sharding.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.train import optim
from repro_torch.train.optim import AdamWConfig


def model_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, sorted: the tree the train step,
    the optimizer and the checkpoints take."""
    return dict(sorted(model.named_parameters()))


def make_loss_fn(model):
    """loss_fn(batch) -> (loss, metrics) of the model's own parameters."""
    def loss_fn(batch):
        return model.loss(batch)
    return loss_fn


@contextlib.contextmanager
def _trainable(leaves):
    flags = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            yield
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)


def make_train_step(model, opt_cfg: AdamWConfig, *, accum: int = 1,
                    grad_hook: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), where ``params`` is ``model_params(model)``.  ``accum`` > 1
    splits the batch on the leading axis into microbatches whose gradients
    are summed in f32 buffers, as the reference's scan does.  ``grad_hook``
    (e.g. ``runtime.compress.make_compression_hook``) is applied to the
    final gradient dict."""
    loss_fn = make_loss_fn(model)
    own = model_params(model)
    names = list(own)
    leaves = [own[n] for n in names]

    def grads_of(batch):
        loss, metrics = loss_fn(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, grads

    def train_step(params, opt_state, batch):
        if list(params) != names or any(params[n] is not own[n]
                                        for n in names):
            raise ValueError("train_step updates the model's own parameters:"
                             " pass train.steps.model_params(model)")
        with _trainable(leaves):
            if accum == 1:
                loss, _, g = grads_of(batch)
                grads = {n: t.float() for n, t in zip(names, g)}
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % accum:
                    raise ValueError(f"a batch of {rows} rows does not split "
                                     f"into {accum} microbatches")
                m = rows // accum
                grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in own.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(accum):
                    mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                    l, _, g = grads_of(mb)
                    for n, t in zip(names, g):
                        grads[n].add_(t)
                    loss = loss + l
                    del g
                grads = {n: t.div_(accum) for n, t in grads.items()}
                loss = loss / accum
        if grad_hook is not None:
            grads = grad_hook(grads)
        new_params, opt_state, opt_metrics = optim.apply_update(
            opt_cfg, params, grads, opt_state)
        del grads
        with torch.no_grad():
            for n in names:
                own[n].copy_(new_params.pop(n))
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(model):
    """prefill_step(tokens [, frames]) -> (last logits, cache)."""
    if model.cfg.family == "encdec":
        @torch.no_grad()
        def prefill_step(tokens, frames):
            return model.prefill(tokens, frames)
    else:
        @torch.no_grad()
        def prefill_step(tokens):
            return model.prefill(tokens)
    return prefill_step


def make_serve_step(model):
    """serve_step(cache, token [B,1], pos) -> (next_token [B,1] int32,
    cache): one greedy token against the KV cache / recurrent state."""
    @torch.no_grad()
    def serve_step(cache, token, pos):
        logits, cache = model.decode_step(cache, token, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step
