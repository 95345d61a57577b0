"""Readings that set a cell's limits, many seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--seconds 8] [--only kv_gap,...]

For each seed the cell's program runs with the seed's weights and traffic
(serving: a short window at the cell's load, long enough to finish its
longest requests; training: the job's first steps, then ``--seconds`` of
steps and the late step), and the numbers that decide ``correct`` (or
those named by ``--only``) are read against the reference.  On the control
seeds the control is read too: the program with its own lower precision
switched on (serving: its int8 K/V cache; training: its int8 gradients),
and beside it the reference in float8 in the program's place and, for
training, half of each microbatch left out.  One JSON line a reading.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _serve_seeds(ctx, seeds, seconds, kv_quant=False):
    """(seed, sample, live slots' K/V in every layer) of the program on
    each seed, weights refilled in place under one server."""
    import torch
    import drivers.serve as S
    import workload
    from reference import weights as W
    model_cfg, mix = ctx["config"]["model"], ctx["traffic"]
    model, server = S.build(ctx, kv_quant=kv_quant)
    params = dict(model.named_parameters())
    loop = None
    for seed in seeds:
        W.fill(params, model_cfg, seed)
        loop = S.Loop(server, workload.Requests(mix, model_cfg["vocab_size"],
                                                seed), mix["clients"])
        S.warm(loop, mix)
        t_start, t_end = S.window(loop, seconds)
        live = S.live_kv(server)
        S.drain(loop)
        yield seed, S.sample_of(loop, t_start, t_end, seed)[1], live
    del model, server, params, loop
    gc.collect()
    torch.cuda.empty_cache()


def _serve_row(ctx, seed, seqs, live, only):
    from reference import serve as ref_serve
    model_cfg, dev = ctx["config"]["model"], ctx["device"]
    row = {"seed": seed, "requests": len(seqs),
           "tokens": sum(len(t) for _, t in seqs), "slots": len(live)}
    if "served_gap" in only:
        row["served_gap"] = max(ref_serve.served_gaps(model_cfg, seed, seqs,
                                                      dev))
    if "kv_gap" in only:
        kv = ref_serve.kv_gaps(model_cfg, seed, live, dev)
        row["kv_gap"] = kv[0]["fine"]
        row["kv_layers"] = [[round(g["fine"], 6), round(g["rel"], 6)]
                            for g in kv]
    return row


def serve(ctx, seeds, control, seconds, only):
    from reference import serve as ref_serve
    model_cfg, dev = ctx["config"]["model"], ctx["device"]
    for seed, seqs, live in _serve_seeds(ctx, seeds, seconds):
        row = _serve_row(ctx, seed, seqs, live, only)
        if seed in control and "served_gap" in only:
            row["fp8_reference_gap"] = max(ref_serve.control_gaps(
                model_cfg, seed, seqs, dev))
        yield row
    # the program's own lower precision: its int8 K/V cache
    for seed, seqs, live in _serve_seeds(ctx, sorted(control), seconds,
                                         True):
        yield dict(_serve_row(ctx, seed, seqs, live, only),
                   control="int8 K/V cache")


FIRST = ("data_rows_off", "loss_gap", "grad_gap", "update_gap")
LATE = ("late_loss_gap", "late_grad_gap", "late_update_gap")


def _late(gaps):
    return {f"late_{k}" if k.endswith("_gap") else k: v
            for k, v in gaps.items()}


def train(ctx, seeds, control, seconds, only):
    """The job's first steps and, after ``seconds`` of steps, the late
    step from the state they left, as a run reads them."""
    import torch
    import drivers.train as T
    from reference import train as ref_train
    from reference import weights as W
    from repro_torch.runtime.compress import make_compression_hook
    from repro_torch.train import steps
    model_cfg, job, dev = ctx["config"]["model"], ctx["traffic"], ctx["device"]
    model, step_fn, opt_cfg, pipeline = T.build(ctx)
    params = dict(model.named_parameters())
    n = job["reference_steps"]
    first, late = set(FIRST) & set(only), set(LATE) & set(only)

    def hooked():
        """The program's own lower precision: int8 gradients (a fresh
        hook each time: it keeps a residual of every gradient)."""
        return steps.make_train_step(
            model, opt_cfg, accum=job["accum"],
            grad_hook=make_compression_hook({"value": None}))

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def program(fn, seed, go_on):
        """(readings of the first steps, the kept state and the late
        step's readings, or None)."""
        W.fill(params, model_cfg, seed)
        p, state, data, readings = T.first_steps(model, fn, opt_cfg,
                                                 pipeline, job, seed, dev)
        kept = lr = None
        if go_on:
            step, t0 = n, time.perf_counter()
            while time.perf_counter() < t0 + seconds:
                batch = pipeline.make_global_batch(data, step, device=dev)
                p, state, _ = fn(p, state, batch)
                step += 1
            kept, lr = T.late_step(p, state, fn, opt_cfg, pipeline, data,
                                   step, dev)
        del p, state
        free()
        return readings, kept, lr

    for seed in seeds:
        readings, kept, lr = program(step_fn, seed, bool(late))
        row = {"seed": seed}
        if late:
            row["late_step"] = lr["first"]
            ref = ref_train.resume(model_cfg, job, seed, dev, kept,
                                   lr["first"])
            row["program_late"] = _late(T.gaps(lr, ref))
            row["rows_off"] = T.rows_off(lr, model_cfg, job, seed)
            if seed in control:
                for mode in ("fp8", "half"):
                    other = ref_train.resume(model_cfg, job, seed, dev, kept,
                                             lr["first"], mode=mode)
                    row[f"{mode}_late"] = _late(T.gaps(other, ref))
                    del other
                    free()
                own = steps.model_params(model)
                state = T.restore(own, kept, dev)
                data = pipeline.SyntheticLMData(
                    model.cfg, job["seq_len"], job["global_batch"], seed=seed)
                try:
                    low = T.step_readings(own, state, hooked(), opt_cfg,
                                          pipeline, data, lr["first"], kept,
                                          dev)
                    row["int8_grads_late"] = _late(T.gaps(low, ref))
                except torch.cuda.OutOfMemoryError as e:
                    row["int8_grads_late"] = {"error": f"{e}"[:300]}
                del state, own
            del kept, ref
            free()
        if first:
            ref = ref_train.run(model_cfg, job, seed, dev, n)
            row["program"] = T.gaps(readings, ref)
            row["rows_off"] = row.get("rows_off", 0) + T.rows_off(
                readings, model_cfg, job, seed)
            if seed in control:
                low = program(hooked(), seed, False)[0]
                row["int8_grads"] = T.gaps(low, ref)
                for mode in ("fp8", "half"):
                    other = ref_train.run(model_cfg, job, seed, dev, n,
                                          mode=mode)
                    row[mode] = T.gaps(other, ref)
                    del other
            del ref
        free()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--only", default="",
                    help="the numbers to read, by name (default: all)")
    args = ap.parse_args(argv)
    import run
    for var, sub in run.CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic, limits = run.load_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    ctx = {"config": config, "traffic": traffic, "limits": limits,
           "seed": seeds[0], "device": "cuda", "aot": True}
    only = [s for s in args.only.split(",") if s] or list(limits)
    for row in {"serve": serve, "train": train}[config["driver"]](
            ctx, seeds, control, args.seconds, only):
        print(json.dumps(row), flush=True)
    print("card: " + json.dumps(__import__("common").smi_sample()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
