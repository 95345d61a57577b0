"""Multi-pod dry run: prove the distribution config is coherent, and count it.

Port of ``repro.launch.dryrun``.  For every (arch × shape × mesh) cell, one
rank's step runs once on fake tensors (``FakeTensorMode``: shapes and
dtypes, no data, no memory) over a ``fake`` process group of 256 ranks
(single pod, mesh (16, 16)) or 512 (multi-pod, (2, 16, 16), the ``pod``
axis an extra data-parallel dimension), made in this process and
destroyed after the cell.  ``launch.hlo_cost`` counts the step's flops,
bytes and collectives and follows its live storage; ``launch.roofline``
turns them into the H100's three roofline terms, and the peak is held
against the card's memory (``hw.HBM_BYTES``).  The count is of the
model's own arithmetic: no kernel is installed at any site (a kernel
cannot run on fake tensors), the same work the card does through K2, K6 or
K7; the plain chunked attention masks rather than skips, so every rank
counts the same work.  Everything here runs on the CPU whatever the
machine has: the dry run asks for ``"cpu"`` itself.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-medium \\
        --shape decode_32k --single-pod [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch.distributed as dist

from repro_torch import hw
from repro_torch.configs import (REGISTRY, SHAPES, cell_applicable,
                                 get_config, get_shape)
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import get_model
from repro_torch.train.steps import rest_sharded

# int8 KV cache for decode cells whose bf16 cache exceeds HBM (MHA-32 @
# batch 128 × 32k = 8.6 GiB/chip in bf16; int8 halves it) — §Known-issues
KV_QUANT_DECODE = {"codeqwen1.5-7b"}


def resolve_rules(cfg, shape, rules_name: str, multi_pod: bool = False) -> str:
    """Per-family baseline config ('auto'), set by the §Perf hillclimbs:

    * train, non-MoE, single-pod → pure FSDP (no TP activation collectives;
      batch 256 == 256 chips).  command-r excepted: its 256k-vocab × 8192-d
      head cannot be FSDP-gathered on a 16 GiB chip → 2D rules.
    * train, non-MoE, multi-pod → context parallel (batch 256 < 512 chips,
      so FSDP would leave the model axis idle; cp shards seq over it).
    * MoE train → 2D rules + shard_map combine-before-reduce (§Perf A).
    * prefill (non-encdec) → context parallel (§Perf B/C/E winners: less
      collective traffic and the only layout that fits dbrx/chameleon).
    * decode → 2D rules + tp_seq KV flash-decode.
    """
    if rules_name != "auto":
        return rules_name
    if shape.kind == "train" and cfg.family != "moe":
        if cfg.name == "command-r-35b":
            return "default"   # 256k-vocab head can't be gathered (cp/fsdp)
        return "cp" if multi_pod else "fsdp"
    if shape.kind == "prefill" and cfg.family != "encdec":
        return "cp"
    return "default"


def fake_ranks(n: int) -> None:
    """A ``fake`` process group of ``n`` ranks in this process, as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def cell_ctx(cfg, shape, mesh, rules_name: str, rec: Dict, *,
             accum: Optional[int], seq_shard: bool, q_chunk: int,
             moe_impl: str):
    """The cell's ctx on ``mesh``: the preset ``rules_name`` with the
    per-kind overrides.  Returns (ctx, ``count_step``'s keywords); what it
    decides is written into ``rec``."""
    if (moe_impl == "einsum" and cfg.family == "moe"
            and shape.kind in ("train", "prefill")):
        moe_impl = "shard_map"          # §Perf A/E default for MoE
        rec["moe_impl"] = moe_impl
    kw = {"moe_impl": moe_impl}
    if rules_name not in ("fsdp", "cp"):
        kw["seq_shard"] = seq_shard
    ctx = make_ctx(mesh, preset=rules_name, **kw)
    if accum is None and rules_name == "fsdp":
        accum = 1  # pure FSDP: batch is 1 seq/chip, microbatching would
        #            degenerate the batch sharding; remat covers memory
    rec["accum"] = accum
    if shape.kind == "long_decode":
        ctx = ctx.replace(rules=dict(ctx.rules, kv_seq="__dp__"),
                          decode_kv="dp_seq")
    elif shape.kind == "decode" and cfg.family != "encdec":
        # big KV caches: shard the cache seq dim over the model axis and
        # LSE-combine (flash-decode) — GQA head counts need not divide TP
        ctx = ctx.replace(rules=dict(ctx.rules, kv_seq="__tp__",
                                     kv_heads=None),
                          decode_kv="tp_seq")
    elif shape.kind == "prefill":
        # produced caches leave prefill in the serving layout (the port's
        # prefill splits the cache by decode_kv, not by the kv_seq rule)
        ctx = ctx.replace(rules=dict(ctx.rules, kv_seq="__tp__",
                                     kv_heads=None),
                          decode_kv=("tp_seq" if cfg.family != "encdec"
                                     else ctx.decode_kv))
    if q_chunk == 256 and cfg.d_model >= 8192 and shape.kind == "prefill":
        q_chunk = 64   # cp keeps all heads per chip: bound the f32 score
        rec["q_chunk"] = q_chunk  # buffer at [B,KV,G,64,32768]
    kv_quant = (shape.kind == "decode" and cfg.family != "encdec"
                and cfg.name in KV_QUANT_DECODE)
    rec["kv_quant"] = kv_quant
    return ctx, {"accum": accum, "q_chunk": q_chunk, "kv_quant": kv_quant}


def step_specs(cfg, shape, ctx, *, accum: Optional[int] = None,
               q_chunk: int = 256, remat: bool = True,
               loss_chunk: int = 1024, kv_quant: bool = False):
    """The cell's model on ``"cpu"``, at rest in its layouts (a train
    step trains the pieces, serving gathers a layer as it runs), and
    ``input_specs``' (fn, args, in_shardings, out_shardings, donate):
    call under a ``FakeTensorMode``."""
    mkw = {"kv_quant": kv_quant} if cfg.family != "encdec" else {}
    model = get_model(cfg, "cpu", ctx=ctx, q_chunk=q_chunk, remat=remat,
                      loss_chunk=loss_chunk, **mkw)
    if ctx.enabled:
        rest_sharded(model)
    return input_specs(cfg, shape, model, ctx, accum=accum)


def count_step(cfg, shape, ctx, **kw):
    """One rank's step of the cell (``cfg``, ``shape``) under ``ctx`` (a
    null ctx: one card), built and run once on fake tensors under the
    counter (``kw``: ``step_specs``'): (``hlo_cost.Counter``,
    ``hlo_cost.Memory``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    if ops.active_sites():
        raise ValueError(f"impls installed at {sorted(ops.active_sites())}: "
                         "the dry run counts the model's own arithmetic, and "
                         "no kernel runs on fake tensors")
    with FakeTensorMode():
        fn, args, _, _, _ = step_specs(cfg, shape, ctx, **kw)
        counter = hlo_cost.Counter(hlo_cost.LiveBytes(args))
        with counter:
            out = fn(*args)
        return counter, counter.live.memory(out)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             accum: Optional[int] = None, rules_name: str = "auto",
             seq_shard: bool = True, q_chunk: int = 256,
             remat: bool = True, verbose: bool = True,
             moe_impl: str = "einsum", ssm_chunk: Optional[int] = None,
             loss_chunk: int = 1024) -> Dict:
    cfg = get_config(arch)
    if ssm_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rules_name = resolve_rules(cfg, shape, rules_name, multi_pod)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "rules": rules_name, "accum": accum, "seq_shard": seq_shard,
                 "moe_impl": moe_impl, "ssm_chunk": ssm_chunk,
                 "q_chunk": q_chunk}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec

    t0 = time.time()
    n_chips = 512 if multi_pod else 256
    fake_ranks(n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        ctx, kw = cell_ctx(cfg, shape, mesh, rules_name, rec, accum=accum,
                           seq_shard=seq_shard, q_chunk=q_chunk,
                           moe_impl=moe_impl)
        counter, mem = count_step(cfg, shape, ctx, remat=remat,
                                  loss_chunk=loss_chunk, **kw)
    finally:
        dist.destroy_process_group()
    t_count = time.time() - t0

    roof = rl.from_cost(counter.cost, n_chips=n_chips,
                        model_flops_total=rl.model_flops(cfg, shape))
    fits = bool(mem.peak_bytes <= hw.HBM_BYTES)
    rec.update(
        status="OK",
        count_s=round(t_count, 2),
        memory={
            "argument_bytes": mem.argument_bytes,
            "output_bytes": mem.output_bytes,
            "temp_bytes": mem.temp_bytes,
            "peak_bytes": mem.peak_bytes,
            "fits_hbm": fits,
        },
        roofline=roof.to_dict(),
    )
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"count {t_count:.1f}s "
              f"peak {mem.peak_bytes / 2**30:.2f} GiB/rank "
              f"fits={fits} "
              f"dominant={roof.dominant} step={roof.step_s * 1e3:.2f} ms "
              f"mfu_bound={roof.model_flops_utilization:.3f}")
        print(f"  memory: {mem}")
        print("  count: flops=%.3e bytes=%.3e (upper %.3e)" % (
            counter.cost.flops, counter.cost.hbm_bytes_ideal,
            counter.cost.hbm_bytes))
        print("  collectives:", roof.collectives.bytes_by_kind)
        if counter.uncounted:
            print("  ops counted by bytes alone:", counter.uncounted)
    return rec


def iter_cells(archs, shapes, meshes):
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                yield arch, shape_name, multi_pod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--rules", default="auto",
                    choices=["auto", "default", "fsdp", "ep", "cp"])
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["einsum", "shard_map"])
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=256)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(REGISTRY)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    if args.multi_pod and not args.single_pod:
        meshes = [True]
    elif args.single_pod and not args.multi_pod:
        meshes = [False]
    else:
        meshes = [False, True]

    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("OK", "SKIP"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("rules", "default")))

    n_ok = n_skip = n_fail = 0
    for arch, shape_name, multi_pod in iter_cells(archs, shapes, meshes):
        mesh_name = "2x16x16" if multi_pod else "16x16"
        resolved = resolve_rules(get_config(arch), get_shape(shape_name),
                                 args.rules, multi_pod)
        if (arch, shape_name, mesh_name, resolved) in done:
            continue
        try:
            rec = run_cell(arch, shape_name, multi_pod=multi_pod,
                           accum=args.accum, rules_name=args.rules,
                           seq_shard=not args.no_seq_shard,
                           q_chunk=args.q_chunk, remat=not args.no_remat,
                           moe_impl=args.moe_impl, ssm_chunk=args.ssm_chunk)
            n_ok += rec["status"] == "OK"
            n_skip += rec["status"] == "SKIP"
            if rec["status"] == "SKIP":
                print(f"[{arch} × {shape_name} × {mesh_name}] SKIP: {rec['reason']}")
        except Exception as e:  # a failed cell is a bug in our sharding
            n_fail += 1
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "rules": args.rules, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[{arch} × {shape_name} × {mesh_name}] FAIL: {e}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"done: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
