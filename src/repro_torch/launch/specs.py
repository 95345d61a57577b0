"""Input stand-ins and layouts for every dry-run cell.

Port of ``repro.launch.specs``.  ``input_specs(cfg, shape, model, ctx)``
returns (fn, args, in_shardings, out_shardings, donate) for the step the
cell runs.  ``sds`` makes a tensor with no data: called under the
caller's ``FakeTensorMode`` (``launch.dryrun``), it allocates nothing.  The
[audio]/[vlm] modality frontends are stubs: whisper's ``frames`` entry is
the precomputed frame embedding, chameleon's VQ image tokens are ordinary
vocab ids.

Ranks run their own pieces (``sharding.ctx``), so every argument is this
rank's piece of its global value, and its layout (a ``sharding.Layout``,
None under a null ctx) says how the global value is split: the batch's
rows over the data axes and, under the ``cp`` preset, its sequence over the
model axis; the moments by their logical axes; the decode cache by rows
and, under ``decode_kv``, by its sequence (``cache_specs``).  The
parameter tree comes first in every step's arguments, as in the JAX
package; it is ``train.model_params(model)``, the model's own tensors,
at rest in their layouts (``train.rest_sharded``) under a ctx: a train
step takes and updates the pieces, serving reads them through the model
rather than as passed.  A model with whole weights (a null ctx, or one
not put at rest) has its train step land the gradients in the
parameters' layouts itself.  The port's decode takes its shared position
as an int.  ``donate`` keeps the JAX package's tuples, though eager PyTorch
has no donation: a train step commits into the model's parameters in
place, and a serve step writes its cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.convert import axes_by_name, by_name
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.train import optim
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.steps import (at_rest, make_prefill_step,
                                     make_serve_step, make_train_step,
                                     model_params)

# grad-accumulation microbatch counts for the train_4k cells (memory fit;
# recorded per-cell in EXPERIMENTS.md §Dry-run)
TRAIN_ACCUM: Dict[str, int] = {
    "glm4-9b": 2, "codeqwen1.5-7b": 2, "stablelm-3b": 1,
    "command-r-35b": 8, "hymba-1.5b": 1, "dbrx-132b": 4,
    "qwen2-moe-a2.7b": 1, "chameleon-34b": 4, "whisper-medium": 1,
    "rwkv6-7b": 2,
}


def sds(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` whose values are never read
    (the JAX ``ShapeDtypeStruct``): fake under a ``FakeTensorMode``."""
    return torch.empty(tuple(shape), dtype=dtype)


def _piece(layout, shape):
    return tuple(shape) if layout is None else layout.local_shape(shape)


def token_layout(ctx: ShardCtx, B: int, S: int):
    """The layout of a [B, S] batch entry: rows over the data axes, and the
    sequence over the model axis under context parallelism."""
    return ctx.sharding(("batch", "seq" if ctx.attn_impl == "cp" else None),
                        (B, S))


def batch_specs(cfg: ModelConfig, B: int, S: int, ctx: ShardCtx):
    sh: Dict[str, Any] = {"tokens": token_layout(ctx, B, S),
                          "targets": token_layout(ctx, B, S)}
    args: Dict[str, Any] = {
        k: sds(_piece(sh[k], (B, S)), torch.int32) for k in sh}
    if cfg.family == "encdec":
        F, d = cfg.encoder.n_frames, cfg.d_model
        sh["frames"] = ctx.sharding(("batch", None, None), (B, F, d))
        args["frames"] = sds(_piece(sh["frames"], (B, F, d)), torch.bfloat16)
    return args, sh


def cache_specs(model, ctx: ShardCtx, B: int, S: int):
    """(this rank's piece of a [B, S] decode cache, its layouts): rows over
    the data axes, the K/V sequence over the axes ``ctx.decode_kv`` names,
    every other dim whole, as the port's ranks hold it: a tensor-parallel
    rank holds every KV head of a cache whose sequence is split, and only
    its own of one that is whole where attention splits (whisper's decode
    cells), and the recurrent state of its heads (wkv, ssm) and channels
    (conv) where the mixer splits (``LM.init_cache``)."""
    seq = {"tp_seq": ctx.tp, "dp_seq": ctx.dp}.get(ctx.decode_kv)
    rules = {**{k: None for k in ctx.rules}, "batch": "__dp__",
             "kv_seq": seq}
    tp = model._tp(1) if ctx.enabled else None
    if tp is not None:
        if seq is None and model._splits("attn"):
            rules["kv_heads"] = ctx.tp
        if model._splits("time_mix") or model._splits("mamba"):
            rules.update(heads=ctx.tp, ffn=ctx.tp)
    whole = ctx.replace(rules=rules)
    shapes = model.cache_shapes(B, S)
    sh = whole.tree_shardings(model.cache_axes(), shapes)
    return {n: sds(_piece(sh[n], shape), dtype)
            for n, (shape, dtype) in shapes.items()}, sh


def param_specs(model, ctx: ShardCtx):
    """(the model's parameters by name, their logical axes, their
    layouts), the layouts from ``model.param_shapes()`` and
    ``param_axes()``."""
    cfg = model.cfg
    axes = axes_by_name(cfg, model.param_axes())
    shapes = by_name(cfg, model.param_shapes(), lambda sh, i: sh[1:])
    return model_params(model), axes, ctx.tree_shardings(axes, shapes)


def _step_of_params(step):
    """``step`` taking the parameter tree first, as the JAX steps do (the
    port's serving steps read the model's own parameters)."""
    def fn(params, *args):
        return step(*args)
    return fn


def input_specs(cfg: ModelConfig, shape: ShapeSpec, model, ctx: ShardCtx, *,
                accum: Optional[int] = None,
                opt_cfg: Optional[AdamWConfig] = None,
                grad_hook=None):
    """Returns (fn, args, in_shardings, out_shardings, donate_argnums)."""
    B, S = shape.global_batch, shape.seq_len
    params, axes, p_sh = param_specs(model, ctx)

    if shape.kind == "train":
        accum = accum if accum is not None else TRAIN_ACCUM.get(cfg.name, 1)
        opt_cfg = opt_cfg or AdamWConfig()
        layouts = p_sh if ctx.enabled else None
        rest = ctx.enabled and at_rest(model)
        opt = optim.init_state(params, layouts)
        opt_sh = ctx.tree_shardings(optim.state_axes(axes), {
            "mu": {n: tuple(p.shape) for n, p in params.items()},
            "nu": {n: tuple(p.shape) for n, p in params.items()},
            "step": ()})
        batch, batch_sh = batch_specs(cfg, B, S, ctx)
        fn = make_train_step(model, opt_cfg, accum=accum, grad_hook=grad_hook,
                             grad_shardings=None if rest else layouts)
        args = (params, opt, batch)
        in_sh = (p_sh if rest else None, opt_sh, batch_sh)
        out_sh = (p_sh if rest else None, opt_sh, None)
        return fn, args, in_sh, out_sh, (0, 1)

    cache, cache_sh = cache_specs(model, ctx, B, S)
    if shape.kind == "prefill":
        fn = _step_of_params(make_prefill_step(model))
        tok_sh = token_layout(ctx, B, S)
        tok = sds(_piece(tok_sh, (B, S)), torch.int32)
        # the produced cache leaves in its serving layout
        out_sh = (None, cache_sh)
        if cfg.family == "encdec":
            F, d = cfg.encoder.n_frames, cfg.d_model
            f_sh = ctx.sharding(("batch", None, None), (B, F, d))
            args = (params, tok, sds(_piece(f_sh, (B, F, d)), torch.bfloat16))
            in_sh = (p_sh, tok_sh, f_sh)
        else:
            args = (params, tok)
            in_sh = (p_sh, tok_sh)
        return fn, args, in_sh, out_sh, ()

    # decode / long_decode: one new token vs a cache of length S
    fn = _step_of_params(make_serve_step(model))
    tok_sh = ctx.sharding(("batch", None), (B, 1))
    args = (params, cache, sds(_piece(tok_sh, (B, 1)), torch.int32), 0)
    in_sh = (p_sh, cache_sh, tok_sh, None)
    out_sh = (None, cache_sh)
    return fn, args, in_sh, out_sh, (1,)
