"""The port's distributed layer across real ranks, held against the JAX
package: the counterparts of ``tests/test_perf_variants.py`` and
``tests/test_distributed.py``.

Ranks are ``torch.distributed`` processes on the gloo backend, meeting
through a ``FileStore`` under the test's temporary directory (a free-port
rendezvous would collide between xdist workers).  One group of four ranks
(mesh (2, 2) as (data, model)) runs every check's rank-side work in one
spawn; a group of two (mesh (1, 2)) restores the checkpoint the four
saved.  The JAX side runs in this process on one device, where its
unsharded result is the reference, and ``compressed_psum`` under
``shard_map`` in a subprocess on four fake devices, as the JAX package's
own tests run it.  The rank processes import neither ``jax`` nor
``repro``: the JAX imports of this module are inside its functions.
"""
import dataclasses
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CP_ARCHS = ("glm4-9b", "hymba-1.5b", "rwkv6-7b", "command-r-35b")
RANK_JOBS = ("cp", "rest", "moe", "decode", "train", "psum", "batch",
             "moe_train", "rest_train", "rest_families", "ckpt_save")
MOE_ARCH = "qwen2-moe-a2.7b"
# one config of each family, trained at rest against the JAX package's
# single-device step and the port's own single-process step
FAMILY_ARCHS = ("glm4-9b", "chameleon-34b", "dbrx-132b", "rwkv6-7b",
                "hymba-1.5b", "whisper-medium")
SPAWN_TIMEOUT_S = 300
CP_TOL = 3e-3                      # tests/test_perf_variants.py's
TRAIN_LOSS_TOL = 1e-3              # tests/test_distributed.py's
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
PSUM_RES_TOL = 1e-6


def port_cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def load(tmp, name):
    return torch.load(os.path.join(tmp, name + ".pt"), weights_only=False)


# ---- rank side (no jax here) -------------------------------------------
def job_cp(mesh, rank, tmp):
    """Context-parallel forward of each arch on this rank's (rows, S/n)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import get_model
    from repro_torch.sharding import comm
    ctx = make_ctx(mesh, preset="cp")
    out = {}
    for arch in CP_ARCHS:
        toks = load(tmp, f"tokens_{arch}")
        model = get_model(port_cfg(arch), "cpu", ctx=ctx)
        model.load_state_dict(load(tmp, f"params_{arch}"))
        lay = ctx.sharding(("batch", "seq"), tuple(toks.shape))
        gathers = comm.calls["all_gather"]
        with torch.no_grad():
            hidden, _ = model.forward(lay.shard(toks))
        out[arch] = {"hidden": hidden, "bounds": lay.bounds(toks.shape),
                     "gathers": comm.calls["all_gather"] - gathers}
        if arch == "glm4-9b":                 # K2's plain version installed
            offsets = []

            def k2(*a, **kw):
                offsets.append(kw.get("q_offset"))
                return flash_attention(*a, device="cpu", **kw)
            with ops.use_impl("attention", k2), torch.no_grad():
                hidden, _ = model.forward(lay.shard(toks))
            out["glm4-9b+k2"] = {"hidden": hidden, "offsets": offsets,
                                 "bounds": lay.bounds(toks.shape)}
    return out


def job_moe(mesh, rank, tmp):
    """dbrx's MoE combine-before-reduce on this rank's batch rows."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import get_model
    from repro_torch.sharding import comm
    toks = load(tmp, "tokens_moe")
    ctx = make_ctx(mesh, preset="default", moe_impl="shard_map",
                   seq_shard=False)
    model = get_model(port_cfg("dbrx-132b"), "cpu", ctx=ctx)
    model.load_state_dict(load(tmp, "params_dbrx-132b"))
    lay = ctx.sharding(("batch", None), tuple(toks.shape))
    reduces = comm.calls["all_reduce"]
    with torch.no_grad():
        hidden, _ = model.forward(lay.shard(toks))
    return {"hidden": hidden, "bounds": lay.bounds(toks.shape),
            "reduces": comm.calls["all_reduce"] - reduces}


def job_rest(mesh, rank, tmp):
    """glm4-9b's weights at rest in the fsdp layout (a quarter of each
    sharded leaf a rank, DTensors), the forward of this rank's row
    gathering each layer's; and ``gather_fsdp`` / ``constrain`` moving a
    DTensor between the presets' layouts."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import get_model
    from repro_torch.sharding import ShardCtx, full
    from repro_torch.train.steps import rest_sharded
    toks = load(tmp, "tokens_glm4-9b")
    whole = load(tmp, "params_glm4-9b")
    ctx = make_ctx(mesh, preset="fsdp")
    model = get_model(port_cfg("glm4-9b"), "cpu", ctx=ctx)
    model.load_state_dict(whole)
    rest_sharded(model)
    lay = ctx.sharding(("batch", None), tuple(toks.shape))
    with torch.no_grad():
        hidden, _ = model.forward(lay.shard(toks))
    wq = model.layers[0].wq
    gathered = ctx.gather_fsdp(wq, ("d_model", "heads"))
    default = ShardCtx(mesh=mesh)
    tp_only = default.gather_fsdp(default.sharding(
        ("d_model", "heads"), tuple(wq.shape)).redistribute(wq),
        ("d_model", "heads"))
    back = default.constrain(gathered, "d_model", "heads")
    # whisper under the same ctx, its weights at rest too: this rank's row
    # of the decoder's hidden states and its share of the loss
    from repro_torch.sharding import comm
    wcfg = port_cfg("whisper-medium")
    plain = get_model(wcfg, "cpu")
    plain.init_params(torch.Generator().manual_seed(3))
    wmodel = get_model(wcfg, "cpu", ctx=ctx)
    wmodel.load_state_dict(plain.state_dict())
    rest_sharded(wmodel)
    g = torch.Generator().manual_seed(4)
    batch = {"frames": torch.randn(4, wcfg.encoder.n_frames, wcfg.d_model,
                                   generator=g),
             "tokens": torch.randint(0, wcfg.vocab_size, (4, 8), generator=g),
             "targets": torch.randint(0, wcfg.vocab_size, (4, 8),
                                      generator=g)}
    r0, r1 = lay.bounds(tuple(toks.shape))[0]
    mine = {k: v[r0:r1] for k, v in batch.items()}
    with torch.no_grad():
        want = plain.decode_parallel(batch["tokens"][r0:r1],
                                     plain.encode(batch["frames"][r0:r1]))[0]
        got = wmodel.decode_parallel(mine["tokens"],
                                     wmodel.encode(mine["frames"]))[0]
        share, _ = wmodel.loss(mine)
        plain_loss, _ = plain.loss(batch)
    summed = comm.all_reduce(share, ctx.group(ctx.batch_axes))
    return {
        "whisper_err": float((got - want).abs().max()),
        "whisper_loss": [float(summed), float(plain_loss)],
        "hidden": hidden, "bounds": lay.bounds(toks.shape),
        "held": sum(p.to_local().numel() for p in model.parameters()),
        "whole": sum(t.numel() for t in whole.values()),
        "gathered": [repr(p) for p in gathered.placements],
        "gathered_equal": torch.equal(gathered.to_local(),
                                      whole["layers.0.wq"]),
        "tp_only": [repr(p) for p in tp_only.placements],
        "tp_only_equal": torch.equal(full(tp_only), whole["layers.0.wq"]),
        "back": [repr(p) for p in back.placements],
        "back_equal": torch.equal(full(back), whole["layers.0.wq"])}


def job_decode(mesh, rank, tmp):
    """Prefill then one decode step with the cache's sequence split over
    the model axis (tp_seq, exact and int8 caches) and over the data axes
    (dp_seq)."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import get_model
    from repro_torch.serve import generate
    from repro_torch.sharding import DEFAULT_RULES
    toks = load(tmp, "tokens_decode")
    base = make_ctx(mesh, preset="default")
    tp_seq = base.replace(rules=dict(DEFAULT_RULES, kv_seq="__tp__",
                                     kv_heads=None), decode_kv="tp_seq")
    out = {}
    for name, ctx, kv_quant, split in (
            ("tp_seq", tp_seq, False, True),
            ("tp_seq_int8", tp_seq, True, True),
            ("dp_seq", base.replace(decode_kv="dp_seq"), False, False)):
        model = get_model(port_cfg("glm4-9b"), "cpu", ctx=ctx,
                          kv_quant=kv_quant)
        model.load_state_dict(load(tmp, "params_glm4-9b"))
        lay = ctx.sharding(("batch", None), tuple(toks.shape))
        mine = lay.shard(toks) if split else toks
        with torch.no_grad():
            logits, cache = model.prefill(mine, max_len=32)
            tok = logits[:, -1].argmax(-1)[:, None]
            step, _ = model.decode_step(cache, tok, 16)
        out[name] = {"logits": step, "cache_len": cache["k"].shape[2],
                     "rows": lay.bounds(toks.shape)[0] if split
                     else (0, toks.shape[0])}
    # generate() on cp shards: rows over data, S/2 over model, tp_seq cache
    ctx = make_ctx(mesh, preset="cp", decode_kv="tp_seq")
    model = get_model(port_cfg("glm4-9b"), "cpu", ctx=ctx)
    model.load_state_dict(load(tmp, "params_glm4-9b"))
    lay = ctx.sharding(("batch", "seq"), tuple(toks.shape))
    out["cp_generate"] = {
        "tokens": generate(model, lay.shard(toks).numpy(), max_new=6,
                           device="cpu"),
        "rows": lay.bounds(toks.shape)[0]}
    return out


def job_train(mesh, rank, tmp):
    """One AdamW step of stablelm-3b on this rank's rows: the JAX test's
    ctx (default rules) and the fsdp preset with gradients landing in the
    parameters' layouts, and the default ctx with all-reduced gradients."""
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import get_model
    from repro_torch.sharding import ShardCtx, comm
    from repro_torch.train import optim
    from repro_torch.train.steps import (make_train_step, model_params,
                                         param_layouts)
    cfg = port_cfg("stablelm-3b")
    data = SyntheticLMData(cfg, 32, 8, seed=1)
    out = {}
    for name, ctx, landed in (
            ("default_reduce_scatter", ShardCtx(mesh=mesh), True),
            ("fsdp_reduce_scatter", make_ctx(mesh, preset="fsdp"), True),
            ("default_all_reduce", ShardCtx(mesh=mesh), False)):
        model = get_model(cfg, "cpu", ctx=ctx)
        model.load_state_dict(load(tmp, "params_stablelm-3b"))
        params = model_params(model)
        layouts = param_layouts(model) if landed else None
        opt = optim.init_state(params, layouts)
        step = make_train_step(model, optim.AdamWConfig(lr=1e-3),
                               grad_shardings=layouts)
        batch = make_global_batch(data, 0, "cpu", sharding=ctx.sharding(
            ("batch", None), (8, 32)))
        calls = dict(comm.calls)
        _, opt, metrics = step(params, opt, batch)
        out[name] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "rows": batch["tokens"].shape[0],
            "calls": {k: comm.calls[k] - calls[k] for k in calls},
            "mu_numel": sum(t.numel() for t in opt["mu"].values()),
            "params": ({n: p.detach().clone() for n, p in params.items()}
                       if rank == 0 else None)}
    return out


def train_once(model, batch, *, accum=1, grad_shardings=None):
    """One AdamW step (lr 1e-3) of ``model`` on ``batch``: (metrics as
    floats, the whole updated parameters (every rank gathers them), the
    moment elements this rank holds, the collectives made)."""
    from repro_torch.sharding import comm, full
    from repro_torch.train import optim
    from repro_torch.train.steps import (make_train_step, model_params,
                                         param_layouts)
    params = model_params(model)
    layouts = param_layouts(model) if model.ctx.enabled else None
    opt = optim.init_state(params, layouts)
    step = make_train_step(model, optim.AdamWConfig(lr=1e-3), accum=accum,
                           grad_shardings=grad_shardings)
    calls = dict(comm.calls)
    _, opt, metrics = step(params, opt, batch)
    made = {k: comm.calls[k] - calls[k] for k in calls}
    return ({k: float(v) for k, v in metrics.items()},
            {n: full(p).detach().clone() for n, p in params.items()},
            sum(t.numel() for t in opt["mu"].values()), made)


def job_moe_train(mesh, rank, tmp):
    """qwen2-moe-a2.7b's loss shares and one AdamW step, its weights at
    rest, under ``default`` (rows over data, the MoE combine-before-reduce
    over model) and ``cp`` (the sequence over model too); and under
    ``default`` with whole weights landing their gradients."""
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import token_layout
    from repro_torch.models import get_model
    from repro_torch.sharding import comm
    from repro_torch.train.steps import param_layouts, rest_sharded
    cfg = port_cfg(MOE_ARCH)
    data = SyntheticLMData(cfg, 32, 8, seed=2)
    out = {}
    for name, preset, rest in (("default", "default", True),
                               ("cp", "cp", True),
                               ("default_whole", "default", False)):
        ctx = make_ctx(mesh, preset=preset, moe_impl="shard_map")
        model = get_model(cfg, "cpu", ctx=ctx)
        model.load_state_dict(load(tmp, f"params_{MOE_ARCH}"))
        if rest:
            rest_sharded(model)
        batch = make_global_batch(data, 0, "cpu",
                                  sharding=token_layout(ctx, 8, 32))
        with torch.no_grad():
            share, metrics = model.loss(batch)
        loss = float(comm.all_reduce(share, ctx.group(ctx.batch_axes)))
        m, params, mu, made = train_once(
            model, batch, grad_shardings=None if rest
            else param_layouts(model))
        out[name] = {"loss_fn": loss, "aux": float(metrics["aux"]),
                     "metrics": m, "mu_numel": mu, "calls": made,
                     "params": params if rank == 0 else None}
    return out


def job_rest_train(mesh, rank, tmp):
    """stablelm-3b at rest under ``fsdp`` and ``default`` with accum 1 and
    2, beside the same step with whole weights landing their gradients;
    and one step of whisper-medium at rest under ``fsdp``."""
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import token_layout
    from repro_torch.models import get_model
    from repro_torch.train.steps import param_layouts, rest_sharded
    cfg = port_cfg("stablelm-3b")
    data = SyntheticLMData(cfg, 32, 8, seed=1)
    out = {}
    for preset in ("fsdp", "default"):
        ctx = make_ctx(mesh, preset=preset)
        batch = make_global_batch(data, 0, "cpu",
                                  sharding=token_layout(ctx, 8, 32))
        for accum in (1, 2):
            for rest in (True, False):
                model = get_model(cfg, "cpu", ctx=ctx)
                model.load_state_dict(load(tmp, "params_stablelm-3b"))
                if rest:
                    rest_sharded(model)
                m, params, mu, made = train_once(
                    model, batch, accum=accum, grad_shardings=None if rest
                    else param_layouts(model))
                out[(preset, accum, rest)] = {
                    "metrics": m, "mu_numel": mu, "calls": made,
                    "params": params if rank == 0 else None}
    wcfg = port_cfg("whisper-medium")
    ctx = make_ctx(mesh, preset="fsdp")
    model = get_model(wcfg, "cpu", ctx=ctx)
    model.load_state_dict(load(tmp, "params_whisper-medium"))
    rest_sharded(model)
    whole = load(tmp, "batch_whisper-medium")
    rows = token_layout(ctx, *whole["tokens"].shape)
    r0, r1 = rows.bounds(tuple(whole["tokens"].shape))[0]
    m, params, mu, made = train_once(model, {k: v[r0:r1]
                                             for k, v in whole.items()})
    out["whisper"] = {"metrics": m, "mu_numel": mu, "calls": made,
                      "params": params if rank == 0 else None}
    return out


def job_rest_families(mesh, rank, tmp):
    """One config of each family at rest under ``fsdp`` and ``cp`` (whisper
    under ``fsdp`` only: its sequence is never split) on the JAX side's
    weights and batch, beside the port's single-process step on the whole
    batch; and under ``fsdp`` with accum 2."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import token_layout
    from repro_torch.models import get_model
    from repro_torch.train.steps import rest_sharded
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = port_cfg(arch)
        start = load(tmp, f"params_{arch}")
        batch = load(tmp, f"family_batch_{arch}")
        plain = get_model(cfg, "cpu")
        plain.load_state_dict(start)
        want_m, want, _, _ = train_once(plain, batch)
        rows, seq = batch["tokens"].shape
        for preset, accum in (("fsdp", 1), ("cp", 1), ("fsdp", 2)):
            if cfg.family == "encdec" and preset == "cp":
                continue
            ctx = make_ctx(mesh, preset=preset)
            model = get_model(cfg, "cpu", ctx=ctx)
            model.load_state_dict(start)
            rest_sharded(model)
            lay = token_layout(ctx, rows, seq)
            mine = {k: lay.shard(v) if k != "frames" else
                    v[slice(*lay.bounds((rows, seq))[0])]
                    for k, v in batch.items()}
            m, params, _, _ = train_once(model, mine, accum=accum)
            if accum > 1:
                out[(arch, preset, accum)] = {
                    "metrics": m, "params": params if rank == 0 else None}
                continue
            out[(arch, preset)] = {
                "metrics": m, "want_metrics": want_m,
                "params": params if rank == 0 else None,
                "tol_ratio": max(float(((params[n] - want[n]).abs() / (
                    TRAIN_RTOL * want[n].abs() + TRAIN_ATOL)).max())
                    for n in want)}
    return out


def job_psum(mesh, rank, tmp):
    """compressed_psum of this rank's rows over all four ranks, twice (the
    second call carrying the first's residual)."""
    from repro_torch.runtime.compress import compressed_psum
    from repro_torch.sharding import ShardCtx
    ctx = ShardCtx(mesh=mesh)
    axes = ("data", "model")
    x = torch.from_numpy(np.load(os.path.join(tmp, "psum_x.npy")))
    i, rows = ctx.index(axes), x.shape[0] // ctx.axis_size(axes)
    mine = x[i * rows:(i + 1) * rows]
    total, res = compressed_psum(mine, ctx.group(axes))
    total2, res2 = compressed_psum(mine, ctx.group(axes), res)
    return {"index": i, "total": total, "res": res, "total2": total2,
            "res2": res2}


def job_batch(mesh, rank, tmp):
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch.mesh import make_ctx
    data = SyntheticLMData(port_cfg("stablelm-3b"), 16, 8, seed=5)
    out = {}
    for preset in ("default", "fsdp"):
        lay = make_ctx(mesh, preset=preset).sharding(("batch", None), (8, 16))
        b = make_global_batch(data, 3, "cpu", sharding=lay)
        out[preset] = {**b, "bounds": lay.bounds((8, 16))}
    return out


def _ckpt_tree_layout(ctx):
    return ctx.sharding(("d_model", None), (8, 6))


def job_ckpt_save(mesh, rank, tmp):
    """A tree with a DTensor leaf split four ways, saved asynchronously."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_ctx
    arrays = load(tmp, "ckpt_arrays")
    lay = _ckpt_tree_layout(make_ctx(mesh, preset="fsdp"))
    tree = {"params": {"w": lay.dtensor(lay.shard(arrays["w"]).clone()),
                       "e": arrays["e"]}, "step": arrays["step"]}
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    mgr.save(7, tree, extra={"world": dist.get_world_size()})
    mgr.wait()
    return {"piece_rows": lay.bounds((8, 6))[0]}


def job_ckpt_restore(mesh, rank, tmp):
    """The four ranks' checkpoint onto this group's mesh, by layouts and
    into a DTensor leaf."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.mesh import make_ctx
    lay = _ckpt_tree_layout(make_ctx(mesh, preset="fsdp"))
    like = {"params": {"w": torch.zeros(lay.local_shape((8, 6))),
                       "e": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}
    shardings = {"params": {"w": lay, "e": None}, "step": None}
    got, step, extra = load_checkpoint(os.path.join(tmp, "ckpt"), like,
                                       shardings=shardings)
    dlike = {"params": {"w": lay.dtensor(torch.zeros(lay.local_shape(
        (8, 6)))), "e": torch.zeros(4, dtype=torch.bfloat16)},
        "step": torch.zeros((), dtype=torch.int32)}
    dgot, _, _ = load_checkpoint(os.path.join(tmp, "ckpt"), dlike)
    return {"w": got["params"]["w"], "e": got["params"]["e"],
            "step_leaf": got["step"], "step": step, "extra": extra,
            "dtensor_w": dgot["params"]["w"].to_local(),
            "rows": lay.bounds((8, 6))[0]}


JOBS = {name: globals()[f"job_{name}"] for name in RANK_JOBS
        + ("ckpt_restore",)}


def _rank_main(rank, n, tmp, jobs, module=None, mesh_shape=None):
    import importlib
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, f"store{n}"), n),
            rank=rank, world_size=n, timeout=timedelta(seconds=120))
        from repro_torch.launch.mesh import make_smoke_mesh
        if mesh_shape is None:
            mesh = make_smoke_mesh(device_type="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                    mesh_dim_names=("data", "model"))
        table = JOBS if module is None else {
            job: getattr(importlib.import_module(module), f"job_{job}")
            for job in jobs}
        for job in jobs:
            torch.save(table[job](mesh, rank, tmp),
                       os.path.join(tmp, f"{job}.{rank}.pt"))
            dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{n}.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(tmp, n, jobs, *, module=None, mesh_shape=None):
    """Runs ``jobs`` on a gloo group of ``n`` ranks; each job's per-rank
    results, in rank order.  ``module`` names the test module whose
    ``job_<name>`` functions they are (this one's by default);
    ``mesh_shape`` the (data, model) mesh (``make_smoke_mesh``'s by
    default)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, tmp, jobs, module, mesh_shape))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errors = "".join(open(os.path.join(tmp, f)).read()
                     for f in sorted(os.listdir(tmp))
                     if f.startswith(f"error{n}."))
    assert not hung and all(p.exitcode == 0 for p in procs), (
        f"ranks failed (exit codes {[p.exitcode for p in procs]}, "
        f"{len(hung)} hung):\n{errors}")
    return {job: [load(tmp, f"{job}.{r}") for r in range(n)] for job in jobs}


# ---- JAX side ------------------------------------------------------------
PSUM_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import shard_map, use_mesh
from repro.runtime.compress import compressed_psum
path = sys.argv[1]
x = np.load(os.path.join(path, "psum_x.npy"))
mesh = jax.make_mesh((4,), ("data",))
def f(xl):
    s1, r1 = compressed_psum(xl, "data")
    s2, r2 = compressed_psum(xl, "data", r1)
    return s1, r1, s2, r2
with use_mesh(mesh):
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=P("data", None),
                            out_specs=(P("data", None),) * 4))(x)
np.savez(os.path.join(path, "psum_jax.npz"),
         **dict(zip(("total", "res", "total2", "res2"),
                    (np.asarray(o) for o in out))))
"""


def jax_side(tmp):
    """The JAX package's unsharded results, and the inputs the ranks load."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data import SyntheticLMData
    from repro.models import get_model
    from repro.serve import generate as jax_generate
    from repro.train import AdamWConfig, init_state
    from repro.train.steps import make_train_step
    from repro_torch.models.convert import params_from_jax

    def save(name, obj):
        torch.save(obj, os.path.join(tmp, name + ".pt"))

    def jcfg(arch):
        return dataclasses.replace(get_config(arch).reduced(),
                                   param_dtype="float32")

    made = {}

    def model_and_params(arch):
        if arch not in made:
            m = get_model(jcfg(arch))
            params = m.init_params(jax.random.PRNGKey(0))
            save(f"params_{arch}", params_from_jax(
                port_cfg(arch), jax.tree.map(np.asarray, params)))
            made[arch] = m, params
        return made[arch]

    ref = {}
    for arch, shape, key in [(a, (4, 32), "cp") for a in CP_ARCHS] + [
            ("dbrx-132b", (8, 32), "moe")]:
        m, params = model_and_params(arch)
        toks = jax.random.randint(jax.random.PRNGKey(1), shape, 0,
                                  jcfg(arch).vocab_size)
        save(f"tokens_{arch}" if key == "cp" else "tokens_moe",
             torch.from_numpy(np.array(toks)).long())
        ref[f"{key}_{arch}"] = np.asarray(jax.jit(m.forward)(params, toks)[0])

    cfg = jcfg("glm4-9b")
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                              cfg.vocab_size)
    save("tokens_decode", torch.from_numpy(np.array(toks)).long())
    params = get_model(cfg).init_params(jax.random.PRNGKey(0))
    ref["generate"] = np.asarray(jax_generate(get_model(cfg), params, toks,
                                              max_new=6))
    for name, kw in (("exact", {}), ("int8", {"kv_quant": True})):
        m = get_model(cfg, **kw)
        logits, cache = m.prefill(params, toks, max_len=32)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        ref[f"decode_{name}"] = np.asarray(
            m.decode_step(params, cache, tok, jnp.int32(16))[0])

    def one_step(arch, m, params, batch, accum=1):
        p_ref, _, m_ref = jax.jit(make_train_step(
            m, AdamWConfig(lr=1e-3), accum=accum))(params, init_state(params),
                                                    batch)
        return {"loss": float(m_ref["loss"]),
                "grad_norm": float(m_ref["grad_norm"]),
                "params": params_from_jax(port_cfg(arch), jax.tree.map(
                    np.asarray, p_ref))}

    m, params = model_and_params("stablelm-3b")
    data = SyntheticLMData(jcfg("stablelm-3b"), 32, 8, seed=1)
    step = one_step("stablelm-3b", m, params, data.batch(0))
    ref["train_loss"] = step["loss"]
    ref["train_grad_norm"] = step["grad_norm"]
    ref["train_params"] = step["params"]
    ref["train_accum2"] = one_step("stablelm-3b", m, params, data.batch(0),
                                   accum=2)
    m, params = model_and_params(MOE_ARCH)
    batch = SyntheticLMData(jcfg(MOE_ARCH), 32, 8, seed=2).batch(0)
    ref["moe_train"] = one_step(MOE_ARCH, m, params, batch)
    ref["moe_train"]["loss_fn"] = float(jax.jit(m.loss)(params, batch)[0])
    m, params = model_and_params("whisper-medium")
    wcfg = jcfg("whisper-medium")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, wcfg.vocab_size, (8, 8)),
             "targets": rng.integers(0, wcfg.vocab_size, (8, 8)),
             "frames": rng.standard_normal((8, wcfg.encoder.n_frames,
                                            wcfg.d_model))}
    batch["targets"][0, :3] = -1
    save("batch_whisper-medium", {
        k: torch.from_numpy(v.astype(np.float32 if k == "frames"
                                     else np.int64))
        for k, v in batch.items()})
    ref["whisper_train"] = one_step("whisper-medium", m, params, {
        k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
        for k, v in batch.items()})
    for arch in FAMILY_ARCHS:
        m, params = model_and_params(arch)
        cfg = jcfg(arch)
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)),
                 "targets": rng.integers(0, cfg.vocab_size, (8, 32))}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (8, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        save(f"family_batch_{arch}", {k: torch.from_numpy(
            v if k == "frames" else v.astype(np.int64))
            for k, v in batch.items()})
        jbatch = {k: jnp.asarray(v, jnp.float32 if k == "frames"
                                 else jnp.int32) for k, v in batch.items()}
        ref[f"family_{arch}"] = one_step(arch, m, params, jbatch)
        # a sharded step's microbatch i is each rank's i-th row (fsdp: 2
        # rows a rank), so JAX's microbatches are taken from the same rows
        # (ROADMAP, "Differences kept on purpose": a moe aux term and its
        # expert capacity are the microbatch's)
        mine = np.arange(8).reshape(4, 2).T.reshape(-1)
        ref[f"family_{arch}_accum2"] = one_step(
            arch, m, params, {k: v[mine] for k, v in jbatch.items()},
            accum=2)
    ref["batch"] = SyntheticLMData(jcfg("stablelm-3b"), 16, 8,
                                   seed=5).batch(3)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(0)
    np.save(os.path.join(tmp, "psum_x.npy"),
            rng.standard_normal((16, 32)).astype(np.float32))
    torch.save({"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(
        np.float32)), "e": torch.tensor([0.5, -1.25, 3.0, 2.0],
                                        dtype=torch.bfloat16),
        "step": torch.tensor(41, dtype=torch.int32)},
        os.path.join(tmp, "ckpt_arrays.pt"))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    psum = subprocess.Popen([sys.executable, "-c", textwrap.dedent(PSUM_JAX),
                             tmp], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ref = jax_side(tmp)
    out = spawn(tmp, 4, RANK_JOBS)
    out.update(spawn(tmp, 2, ("ckpt_restore",)))
    _, err = psum.communicate(timeout=SPAWN_TIMEOUT_S)
    assert psum.returncode == 0, err[-3000:]
    ref["psum"] = dict(np.load(os.path.join(tmp, "psum_jax.npz")))
    ref["psum_x"] = np.load(os.path.join(tmp, "psum_x.npy"))
    ref["ckpt_arrays"] = load(tmp, "ckpt_arrays")
    return out, ref


def rows_cols(bounds):
    (r0, r1), (c0, c1) = bounds
    return slice(r0, r1), slice(c0, c1)


# ---- the checks ------------------------------------------------------------
@pytest.mark.parametrize("arch", CP_ARCHS)
def test_context_parallel_forward_matches_jax(runs, arch):
    """Each rank's (rows, S/n) of the cp forward equals the JAX forward's
    within the JAX test's 3e-3, and K/V were all-gathered every layer."""
    out, ref = runs
    want = ref[f"cp_{arch}"]
    for r in out["cp"]:
        got = r[arch]
        err = np.abs(got["hidden"].numpy() - want[rows_cols(got["bounds"])])
        assert err.max() < CP_TOL, err.max()
        assert got["gathers"] >= port_cfg(arch).n_layers


def test_context_parallel_passes_q_offset_to_the_attention_impl(runs):
    """With K2's plain version installed at ``attention`` each rank's launches
    all carry its shard's offset (the JAX package drops it there)."""
    out, ref = runs
    want = ref["cp_glm4-9b"]
    n_layers = port_cfg("glm4-9b").n_layers
    offsets = set()
    for r in out["cp"]:
        got = r["glm4-9b+k2"]
        rows, cols = rows_cols(got["bounds"])
        assert got["offsets"] == [cols.start] * n_layers
        offsets.add(cols.start)
        err = np.abs(got["hidden"].numpy() - want[rows, cols]).max()
        assert err < CP_TOL, err
    assert offsets == {0, 16}


def test_weights_at_rest_in_the_fsdp_layout_give_the_jax_forward(runs):
    """Each rank holds a quarter of every leaf that splits (DTensor pieces)
    and its row's forward, gathering each layer's weights, equals the JAX
    forward; ``gather_fsdp`` under fsdp gathers a weight whole, under the
    default preset leaves it split over the model axis, and ``constrain``
    splits it again, the values kept.  whisper-medium's weights at rest
    alike: a rank's rows equal the plain model's, and the ranks' loss
    shares sum to the plain model's loss on the whole batch."""
    out, ref = runs
    want = ref["cp_glm4-9b"]
    for r in out["rest"]:
        err = np.abs(r["hidden"].numpy() - want[rows_cols(r["bounds"])])
        assert err.max() < CP_TOL, err.max()
        assert r["held"] < r["whole"] / 2
        assert r["gathered"] == ["Replicate()", "Replicate()"]
        assert r["tp_only"] == ["Replicate()", "Shard(dim=1)"]
        assert r["back"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert r["gathered_equal"] and r["tp_only_equal"] and r["back_equal"]
        assert r["whisper_err"] < 1e-5
        loss, whole = r["whisper_loss"]
        assert abs(loss - whole) < 1e-5 * abs(whole)


def test_moe_combine_before_reduce_matches_jax(runs):
    out, ref = runs
    want = ref["moe_dbrx-132b"]
    for r in out["moe"]:
        err = np.abs(r["hidden"].numpy() - want[rows_cols(r["bounds"])])
        assert err.max() < CP_TOL, err.max()
        assert r["reduces"] >= port_cfg("dbrx-132b").n_layers


@pytest.mark.parametrize("name,jax_name", [("tp_seq", "exact"),
                                           ("tp_seq_int8", "int8"),
                                           ("dp_seq", "exact")])
def test_sequence_sharded_decode_matches_jax(runs, name, jax_name):
    """Decode over a cache whose sequence is split (over the model axis:
    16 of 32 positions a rank; over the data axes) equals the JAX package's
    local decode, with the int8 cache too."""
    out, ref = runs
    want = ref[f"decode_{jax_name}"]
    vocab = port_cfg("glm4-9b").vocab_size
    for r in out["decode"]:
        got = r[name]
        assert got["cache_len"] == 16
        r0, r1 = got["rows"]
        err = np.abs(got["logits"].numpy()[..., :vocab]
                     - want[r0:r1, ..., :vocab]).max()
        assert err < CP_TOL, err


def test_generate_on_context_parallel_shards_matches_jax(runs):
    """generate() on each rank's (rows, S/2) shard, the cache's sequence
    split over the model axis, gives the JAX package's greedy tokens."""
    out, ref = runs
    for r in out["decode"]:
        got = r["cp_generate"]
        r0, r1 = got["rows"]
        np.testing.assert_array_equal(got["tokens"], ref["generate"][r0:r1])


@pytest.mark.parametrize("name", ["default_reduce_scatter",
                                  "fsdp_reduce_scatter",
                                  "default_all_reduce"])
def test_sharded_train_step_matches_single_device_jax(runs, name):
    """One AdamW step on four ranks equals the JAX single-device step
    (``tests/test_distributed.py:30``'s tolerances).  Landed gradients are
    reduce-scattered and the moments are the ranks' pieces."""
    out, ref = runs
    results = [r[name] for r in out["train"]]
    for r in results:
        assert abs(r["loss"] - ref["train_loss"]) < TRAIN_LOSS_TOL
        assert abs(r["grad_norm"] - ref["train_grad_norm"]) < 1e-4 * max(
            1.0, ref["train_grad_norm"])
    for n, want in ref["train_params"].items():
        np.testing.assert_allclose(results[0]["params"][n].numpy(),
                                   want.numpy(), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    full = sum(p.numel() for p in ref["train_params"].values())
    calls = results[0]["calls"]
    if name.endswith("reduce_scatter"):
        assert calls["reduce_scatter"] > 0
        assert results[0]["mu_numel"] < full
    else:
        assert calls["reduce_scatter"] == 0 and results[0]["mu_numel"] == full
    assert sum(r["rows"] for r in results) == (16 if name.startswith(
        "default") else 8)            # data 2 x model 2 (replicated) / 4


def assert_params_close(got, want, **kw):
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n,
                                   **kw)


@pytest.mark.parametrize("name", ["default", "cp", "default_whole"])
def test_moe_loss_and_step_under_a_token_split_match_jax(runs, name):
    """qwen2-moe-a2.7b on four ranks: the loss shares (each with the global
    batch's aux term over the ranks that split the tokens) sum to the JAX
    package's loss, and one AdamW step at rest under ``default`` (the
    combine-before-reduce over the model axis) and ``cp`` (the sequence
    split too), and with whole weights, equals the JAX single-device
    step."""
    out, ref = runs
    want = ref["moe_train"]
    results = [r[name] for r in out["moe_train"]]
    for r in results:
        assert abs(r["loss_fn"] - want["loss_fn"]) < TRAIN_LOSS_TOL
        assert abs(r["metrics"]["loss"] - want["loss"]) < TRAIN_LOSS_TOL
        assert abs(r["metrics"]["grad_norm"] - want["grad_norm"]) < 1e-4 * \
            max(1.0, want["grad_norm"])
        assert r["aux"] > 0
    assert len({r["aux"] for r in results}) == 1     # the global term
    assert_params_close(results[0]["params"], want["params"],
                        rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    full = sum(p.numel() for p in want["params"].values())
    assert results[0]["mu_numel"] < full
    assert results[0]["calls"]["reduce_scatter"] > 0


@pytest.mark.parametrize("preset", ["fsdp", "default"])
@pytest.mark.parametrize("accum", [1, 2])
def test_step_at_rest_matches_jax_and_the_whole_weight_step(runs, preset,
                                                            accum):
    """stablelm-3b with its weights at rest: one AdamW step equals the JAX
    single-device step and the step with whole weights, with accum 1 and
    2; its gradients arrive as pieces (no all-gather of updated weights)
    and its moments are pieces."""
    out, ref = runs
    want = ref["train_params"] if accum == 1 else ref["train_accum2"][
        "params"]
    want_loss = ref["train_loss"] if accum == 1 else ref["train_accum2"][
        "loss"]
    rest = [r[(preset, accum, True)] for r in out["rest_train"]]
    whole = [r[(preset, accum, False)] for r in out["rest_train"]]
    for r, w in zip(rest, whole):
        assert abs(r["metrics"]["loss"] - want_loss) < TRAIN_LOSS_TOL
        for k in ("loss", "grad_norm", "lr"):
            assert abs(r["metrics"][k] - w["metrics"][k]) <= 1e-6 * abs(
                w["metrics"][k])
        assert r["mu_numel"] == w["mu_numel"]
    assert_params_close(rest[0]["params"], want, rtol=TRAIN_RTOL,
                        atol=TRAIN_ATOL)
    assert_params_close(rest[0]["params"], whole[0]["params"], rtol=1e-5,
                        atol=1e-6)
    # at rest every gather is a microbatch's (a weight gathered for its
    # forward and its recompute), none gathers the updated pieces back;
    # with whole weights the gathers are the update's alone
    gathers = {(a, r): out["rest_train"][0][(preset, a, r)]["calls"][
        "all_gather"] for a in (1, 2) for r in (True, False)}
    assert gathers[(2, True)] == 2 * gathers[(1, True)] > 0
    assert gathers[(2, False)] == gathers[(1, False)] > 0
    assert rest[0]["calls"]["reduce_scatter"] > 0


def test_whisper_step_at_rest_matches_jax(runs):
    out, ref = runs
    want = ref["whisper_train"]
    results = [r["whisper"] for r in out["rest_train"]]
    for r in results:
        assert abs(r["metrics"]["loss"] - want["loss"]) < TRAIN_LOSS_TOL
        assert abs(r["metrics"]["grad_norm"] - want["grad_norm"]) < 1e-4 * \
            max(1.0, want["grad_norm"])
    assert_params_close(results[0]["params"], want["params"],
                        rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert results[0]["mu_numel"] < sum(p.numel()
                                        for p in want["params"].values())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains_at_rest(runs, arch):
    """Each family at rest (``fsdp``; ``cp`` too for the decoder-only
    ones: attention's K/V gather, the recurrent scans' and the MoE block's
    gathered sequence reduce-scatter their gradients) equals the JAX
    single-device step (``tests/test_distributed.py:30``'s tolerances) and
    the port's single-process step; under ``fsdp`` with accum 2, the JAX
    step with accum 2 over the same microbatches."""
    out, ref = runs
    want = ref[f"family_{arch}"]
    want2 = ref[f"family_{arch}_accum2"]
    for i, r in enumerate(out["rest_families"]):
        got = r[(arch, "fsdp", 2)]
        assert abs(got["metrics"]["loss"] - want2["loss"]) < TRAIN_LOSS_TOL
        assert abs(got["metrics"]["grad_norm"] - want2["grad_norm"]) \
            < 1e-4 * max(1.0, want2["grad_norm"])
        if i == 0:
            assert_params_close(got["params"], want2["params"],
                                rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        keys = [k for k in r if k[0] == arch and len(k) == 2]
        assert len(keys) == (1 if arch == "whisper-medium" else 2)
        for k in keys:
            got = r[k]
            assert abs(got["metrics"]["loss"] - want["loss"]) \
                < TRAIN_LOSS_TOL, k
            assert abs(got["metrics"]["grad_norm"] - want["grad_norm"]) \
                < 1e-4 * max(1.0, want["grad_norm"]), k
            for m in ("loss", "grad_norm"):
                assert abs(got["metrics"][m] - got["want_metrics"][m]) \
                    < 1e-5 * max(1.0, abs(got["want_metrics"][m])), (k, m)
            assert got["tol_ratio"] <= 1.0, k
            if i == 0:
                assert_params_close(got["params"], want["params"],
                                    rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_compressed_psum_matches_jax_under_shard_map(runs):
    """Both calls' sums equal the JAX package's under ``shard_map`` (the
    second carrying the first's residual), the same on every rank, and the
    residuals agree within 1e-6."""
    out, ref = runs
    jax_out = ref["psum"]
    rows = 4
    for r in out["psum"]:
        i = r["index"]
        for key in ("total", "res", "total2", "res2"):
            want = jax_out[key][i * rows:(i + 1) * rows]
            tol = 0 if key.startswith("total") else PSUM_RES_TOL
            np.testing.assert_allclose(r[key].numpy(), want, rtol=0,
                                       atol=tol, err_msg=key)
    totals = [r["total"] for r in out["psum"]]
    assert all(torch.equal(totals[0], t) for t in totals)


def test_compressed_psum_int_sum_and_residual_formula(runs):
    """The shared scale from every rank's max|x|, each rank's int8 q and
    residual by the formula, here in numpy: the sum is (Σ qᵢ)·s exactly."""
    out, ref = runs
    x = ref["psum_x"]
    scale = np.float32(np.abs(x).max()) / np.float32(127.0) \
        + np.float32(1e-12)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    qsum = q.reshape(4, 4, -1).sum(0)
    for r in out["psum"]:
        i = r["index"]
        np.testing.assert_array_equal(
            r["total"].numpy(), qsum.astype(np.float32) * scale)
        np.testing.assert_allclose(
            r["res"].numpy(), x[i * 4:(i + 1) * 4]
            - q[i * 4:(i + 1) * 4].astype(np.float32) * scale,
            rtol=0, atol=PSUM_RES_TOL)


def test_global_batch_slices_join_into_the_unsharded_batch(runs):
    out, ref = runs
    want = ref["batch"]
    for preset, copies in (("default", 2), ("fsdp", 1)):
        seen = np.zeros(8, int)
        for r in out["batch"]:
            got = r[preset]
            rows, cols = rows_cols(got["bounds"])
            seen[rows] += 1
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              want[k][rows, cols])
        assert (seen == copies).all(), (preset, seen)


def test_checkpoint_saved_on_four_ranks_restores_on_two(runs):
    """A DTensor leaf saved whole by four ranks (rank 0 writing) restores
    onto two: each rank's rows by its layout, into a plain leaf and into a
    DTensor's own piece; the replicated leaves and the step as saved."""
    out, ref = runs
    want = ref["ckpt_arrays"]
    rows = {tuple(r["piece_rows"]) for r in out["ckpt_save"]}
    assert rows == {(0, 2), (2, 4), (4, 6), (6, 8)}
    for r in out["ckpt_restore"]:
        assert r["step"] == 7 and r["extra"] == {"world": 4}
        r0, r1 = r["rows"]
        assert r1 - r0 == 4
        torch.testing.assert_close(r["w"], want["w"][r0:r1], rtol=0, atol=0)
        torch.testing.assert_close(r["dtensor_w"], want["w"][r0:r1], rtol=0,
                                   atol=0)
        assert torch.equal(r["e"], want["e"])
        assert torch.equal(r["step_leaf"], want["step"])
    assert sorted(tuple(r["rows"]) for r in out["ckpt_restore"]) == [
        (0, 4), (4, 8)]
