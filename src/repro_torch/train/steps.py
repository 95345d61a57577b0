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
(``kernels.no_backward``).  Recorded (``repro_torch.tracing``), a step is
a ``train.step`` span over a ``train.forward`` and a ``train.backward`` a
microbatch and one ``train.update``, each with its interval on the device.

Sharded (the model's ``ctx`` on a mesh of ranks), each rank computes the
gradients of its share of the loss (``LM.loss``) on its tokens.  A model
at rest (``rest_sharded``: its parameters are this rank's pieces, as
DTensors) trains at rest, as the JAX package's FSDP step does: the forward
gathers each layer inside its remat body (``sharding.gathered``), whose
backward reduce-scatters the layer's gradient into its layout, so the
gradients arrive as pieces, ``accum`` sums pieces, AdamW updates each
piece in place with moments laid out alike (``optim.init_state(...,
param_layouts(model))``) and the global clipping norm, and no weight or
gradient is ever whole on a rank but the layer that runs.  Under a ctx
whose ``tensor_parallel`` holds (``default``, ``ep``) the step at rest
is Megatron's tensor-parallel step (every family: ``lm.split_parts``
decides which parts split): a layer
is gathered over its FSDP axes alone, each rank of the model axis
computes with its pieces and the same loss, and a weight every model
rank holds whole lands the sum of their gradients where each computes a
part with it (``LM._weight``).  A model with
whole weights holds them on every rank and computes whole gradients:
without ``grad_shardings`` they are summed over the ranks that hold
different tokens (an all-reduce) and every rank takes the same whole
update; with ``grad_shardings`` (``param_layouts``) each gradient lands in
its parameter's layout (a reduce-scatter over the mesh axes that both
split the tokens and shard the parameter, a cut over the others), AdamW
updates this rank's pieces, and the updated pieces are all-gathered into
the model's weights.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.models.convert import axes_by_name
from repro_torch.sharding import comm
from repro_torch.sharding.ctx import _is_dtensor
from repro_torch.train import optim
from repro_torch.train.optim import AdamWConfig


def model_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, sorted: the tree the train step,
    the optimizer and the checkpoints take."""
    return dict(sorted(model.named_parameters()))


def param_layouts(model):
    """name → ``sharding.Layout`` of each of the model's parameters under
    its ctx (the port's parameter shardings; None under a null ctx)."""
    return model.ctx.tree_shardings(
        axes_by_name(model.cfg, model.param_axes()), model_params(model))


def rest_sharded(model) -> None:
    """Puts each of the model's parameters at rest in its layout
    (``param_layouts``): this rank's piece, as a DTensor.  The model's
    forward gathers a layer's weights whole as it runs the layer, so
    serving holds one layer's whole weights at a time, and a train step
    trains the pieces (``make_train_step``)."""
    import torch.nn as nn
    for name, layout in param_layouts(model).items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        piece = layout.shard(getattr(module, leaf).detach()).clone()
        setattr(module, leaf, nn.Parameter(layout.dtensor(piece),
                                           requires_grad=False))


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


def at_rest(model) -> bool:
    """Whether the model's parameters are at rest (DTensor pieces)."""
    return any(_is_dtensor(p) for p in model.parameters())


def make_train_step(model, opt_cfg: AdamWConfig, *, accum: int = 1,
                    grad_hook: Optional[Callable] = None,
                    grad_shardings: Optional[Dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), where ``params`` is ``model_params(model)``.  ``accum`` > 1
    splits the batch on the leading axis into microbatches whose gradients
    are summed in f32 buffers, as the reference's scan does.  ``grad_hook``
    (e.g. ``runtime.compress.make_compression_hook``) is applied to the
    final gradient dict.  A model at rest trains its pieces: its gradients
    and ``opt_state``'s moments are this rank's pieces of the layouts its
    DTensors carry.  With whole weights, ``grad_shardings``
    (``param_layouts(model)``) lands the gradients in the parameters'
    layouts, and ``opt_state`` holds this rank's pieces of the moments."""
    loss_fn = make_loss_fn(model)
    ctx = model.ctx
    summed = ctx.batch_axes if ctx.enabled else ()
    group = ctx.group(summed) if ctx.enabled else None
    everyone = ctx.group(tuple(ctx.mesh.mesh_dim_names)) if ctx.enabled \
        else None
    own = model_params(model)
    names = list(own)
    leaves = [own[n] for n in names]
    rest = ctx.enabled and at_rest(model)
    if rest and grad_shardings is not None:
        raise ValueError("a model at rest lands its gradients in its "
                         "DTensors' layouts: pass no grad_shardings")
    if rest:
        from repro_torch.sharding import Layout
        layouts = {n: Layout.of(p) for n, p in own.items()}
    else:
        layouts = grad_shardings if ctx.enabled else None

    def piece(t):
        return t.to_local() if rest else t

    dev = piece(leaves[0]).device

    def grads_of(batch, micro, into):
        """The microbatch's loss and its gradients as f32 pieces, summed
        into ``into`` where given."""
        with tracing.span("train.forward", dev, micro=micro):
            loss, _ = loss_fn(batch)
        with tracing.span("train.backward", dev, micro=micro):
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
            if into is None:
                return loss.detach(), {n: piece(t).float()
                                       for n, t in zip(names, g)}
            for n, t in zip(names, g):
                into[n].add_(piece(t))
        return loss.detach(), into

    def train_step(params, opt_state, batch):
        with tracing.span("train.step", dev, accum=accum):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if list(params) != names or any(params[n] is not own[n]
                                        for n in names):
            raise ValueError("train_step updates the model's own parameters:"
                             " pass train.steps.model_params(model)")
        with _trainable(leaves):
            if accum == 1:
                loss, grads = grads_of(batch, 0, None)
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % accum:
                    raise ValueError(f"a batch of {rows} rows does not split "
                                     f"into {accum} microbatches")
                m = rows // accum
                grads = {n: torch.zeros(piece(p).shape, dtype=torch.float32,
                                        device=piece(p).device)
                         for n, p in own.items()}
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(accum):
                    mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                    l, grads = grads_of(mb, i, grads)
                    loss = loss + l
        with tracing.span("train.update", dev):
            return update(params, opt_state, grads, loss)

    def update(params, opt_state, grads, loss):
        if accum > 1:
            grads = {n: t.div_(accum) for n, t in grads.items()}
            loss = loss / accum
        loss = comm.all_reduce(loss, group) if ctx.enabled else loss
        gnorm, pieces = None, {n: piece(p) for n, p in params.items()}
        if ctx.enabled and layouts is None:
            grads = {n: comm.all_reduce(g, group) for n, g in grads.items()}
        elif ctx.enabled and not rest:
            grads = {n: layouts[n].land(g, summed) for n, g in grads.items()}
            pieces = {n: layouts[n].shard(p) for n, p in params.items()}
        if grad_hook is not None:
            grads = grad_hook(grads)
        if layouts is not None:
            sq = sum(torch.sum(torch.square(g)) / layouts[n].replicas()
                     for n, g in grads.items())
            gnorm = torch.sqrt(comm.all_reduce(sq, everyone))
        new_params, opt_state, opt_metrics = optim.apply_update(
            opt_cfg, pieces, grads, opt_state, grad_norm=gnorm)
        del grads
        with torch.no_grad():
            for n in names:
                new = new_params.pop(n)
                if rest:
                    own[n].to_local().copy_(new)
                    continue
                if layouts is not None:
                    new = layouts[n].gather(new)
                own[n].copy_(new)
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
