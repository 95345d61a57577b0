"""Checks the program's spans (``repro_torch.tracing``) against the
profiler on a card, and measures what recording costs.

    python3 probes/tracing_check.py trace <cell> --seed N --seconds S
    python3 probes/tracing_check.py cost <cell> --seed N --seconds S [--rounds R]
    python3 probes/tracing_check.py spans

``trace`` runs one traced run of a benchmark cell as ``perfbench/run.py
--trace 1`` does and prints its result line, then reads the session the
traced slice recorded: the device's idle from the program's device
intervals beside the profiler's (``idle.serve`` / ``idle.train``), the
profiler's idle gaps split by the program's device span they fall in, the
idle split by the host span that was open, every ``serve.replay``'s device
interval against its host span's start and its ``serve.readback``'s end,
and in training the ``train.step`` device intervals against the
profiler's busy and window seconds and the share the phases cover.

``cost`` sets a cell up once and runs windows of ``--seconds`` in turns,
without and inside ``tracing.recording()`` (R rounds of off, on, on,
off), and prints each window's mean step time (``step_ms.decode`` and
``step_ms.admit`` of the serving loop, or a train step's: batch and step,
synchronised), and in the recorded windows the per-layer metrics that read
the program's spans, with no profiler running.

``spans`` times the recorder's calls on the host, off and on: a span with
no device, one with the card (two CUDA events), a count, and the read
that resolves the events.

Each prints one JSON line, also written to
``chiprun_out/tracing_<mode>_<cell>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PB = ROOT / "perfbench"
sys.path[:0] = [str(ROOT / "src"), str(PB)]

import common  # noqa: E402
import run  # noqa: E402

SLACK_NS = 50_000
PROGRAM_METRICS = {
    "serve": ("decode_device_ms", "decode_host_ms", "idle_in_step.serve",
              "prefill_pad_share", "prefill_wait_ms"),
    "train": ("forward_ms.train", "backward_ms.train", "update_ms.train",
              "data_draw_ms.train")}
KERNELS = []        # the profiler's device operations of the traced slice


def _keep_kernels(reduce_events):
    def wrapped(events, *args, **kwargs):
        KERNELS[:] = [(e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in events
                      if str(e.device_type()).endswith("CUDA")
                      and not getattr(e, "is_user_annotation",
                                      lambda: False)()]
        return reduce_events(events, *args, **kwargs)
    return wrapped


def _overlap(spans, intervals) -> int:
    """ns of ``spans`` that ``intervals`` (both sorted, each disjoint)
    cover."""
    out, j = 0, 0
    for a, b in spans:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return out


def profiler_gaps_by_span(tracing, sess):
    """The profiler's idle gaps (between the union of its device
    operations) inside the program's session, in ms, split by the name of
    the program's device span whose interval holds them, and ``none``."""
    _, busy = tracing.union(KERNELS)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    dev = [s for s in sess["spans"] if s["device"]]
    if not dev or not gaps:
        return None
    lo = min(s["device"][0] for s in dev)
    hi = max(s["device"][1] for s in dev)
    gaps = [(max(a, lo), min(b, hi)) for a, b in gaps if b > lo and a < hi]
    total = sum(b - a for a, b in gaps)
    out = {}
    for name in sorted({s["name"] for s in dev}):
        _, ivs = tracing.union(s["device"] for s in dev
                                if s["name"] == name)
        out[name] = _overlap(gaps, ivs) / 1e6
    _, every = tracing.union(s["device"] for s in dev)
    out["none"] = (total - _overlap(gaps, every)) / 1e6
    out["total"] = total / 1e6
    return out


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def serve_figures(tracing, sess, result):
    out = {}
    steps = tracing.named(sess, "serve.step")
    out["samples"] = {
        "steps": len(steps),
        "prefills": len(tracing.named(sess, "serve.prefill")),
        "queue": len(tracing.named(sess, "serve.queue")),
        "decode_replays": sum(1 for s in tracing.named(sess, "serve.replay")
                              if s["attrs"]["graph"] == "decode"),
        "captures": len(tracing.named(sess, "serve.capture"))}
    # each replay against its host span's start and its readback's end
    worst_start, worst_end, bad = None, None, 0
    for r in tracing.named(sess, "serve.replay"):
        backs = [s for s in sess["spans"] if s["name"] == "serve.readback"
                 and s["parent"] == r["parent"] and s["t0"] >= r["t1"]]
        if not r["device"] or not backs:
            bad += 1
            continue
        a = r["device"][0] - r["t0"]
        b = backs[0]["t1"] - r["device"][1]
        worst_start = a if worst_start is None else min(worst_start, a)
        worst_end = b if worst_end is None else min(worst_end, b)
        bad += a < -SLACK_NS or b < -SLACK_NS
    out["replay_check"] = {"violations": bad,
                           "least_start_after_host_us": worst_start / 1e3
                           if worst_start is not None else None,
                           "least_end_before_readback_us": worst_end / 1e3
                           if worst_end is not None else None}
    totals = tracing.totals(sess)
    out["spans_ms"] = {n: {"n": t["n"], "host_ms": t["host_ms"],
                           "device_ms": t["device_ms"]}
                       for n, t in sorted(totals.items())}
    selfs = {}
    for name in ("serve.step", "serve.prefill", "serve.commit"):
        xs = [tracing.self_ms(sess, s) for s in tracing.named(sess, name)]
        selfs[name] = _mean(xs)
    out["mean_self_ms"] = selfs
    return out


def train_figures(tracing, sess, result):
    totals = tracing.totals(sess)
    step = totals.get("train.step", {"device_ms": 0.0, "n": 0})
    phases = sum(totals.get(f"train.{p}", {"device_ms": 0.0})["device_ms"]
                 for p in ("forward", "backward", "update"))
    return {"samples": {"steps": step["n"]},
            "train_step_device_s": step["device_ms"] / 1e3,
            "profiler_busy_s": result["device"].get("busy_s"),
            "profiler_window_s": result["device"].get("window_s"),
            "phases_cover": phases / step["device_ms"]
            if step["device_ms"] else None,
            "spans_ms": {n: {"n": t["n"], "host_ms": t["host_ms"],
                             "device_ms": t["device_ms"]}
                         for n, t in sorted(totals.items())}}


def trace(args, bench):
    import torch
    cell, config, traffic, limits = run.load_cell(bench, args.cell)
    common.reduce_events = _keep_kernels(common.reduce_events)
    result = run.execute(bench, cell, config, traffic, limits,
                         seed=args.seed, seconds=args.seconds, trace=True)
    result.pop("details")
    result["device"] = {"kind": torch.cuda.get_device_name(0),
                        **result["device"]}
    print(json.dumps(result), flush=True)
    out = {"cell": args.cell, "seed": args.seed, "correct": result["correct"]}
    try:
        from repro_torch import tracing
    except ImportError:
        out["recorder"] = None
        return out
    sess = tracing.session()
    split = tracing.idle_split(sess)
    if split:
        out["program_window_s"] = split["window_ns"] / 1e9
        out["program_idle_pct"] = 100.0 * (1 - split["busy_ns"]
                                           / split["window_ns"])
        out["idle_ms"] = {k: v / 1e6 for k, v in sorted(split["idle"].items())}
        out["idle_under_ms"] = {k: v / 1e6
                                for k, v in sorted(split["under"].items())}
    idle = result["metrics"].get(f"idle.{config['driver']}")
    out["profiler_idle_pct"] = idle["value"] if idle else None
    out["profiler_gaps_ms_in"] = profiler_gaps_by_span(tracing, sess)
    figures = serve_figures if config["driver"] == "serve" else train_figures
    out.update(figures(tracing, sess, result))
    return out


def cost(args, bench):
    import torch
    import workload
    from repro_torch import tracing
    cell, config, traffic, limits = run.load_cell(bench, args.cell)
    ctx = {"config": config, "traffic": traffic, "limits": limits,
           "seed": args.seed, "seconds": args.seconds, "trace": False,
           "device": "cuda", "aot": True, "t0": time.perf_counter()}
    windows = []
    modes = [False, True, True, False] * args.rounds
    kind = config["driver"]

    def program_metrics(on):
        if not on:
            return {}
        rec = {"kind": kind, "trace": {}}
        return {m: run._reader(m)(rec) for m in PROGRAM_METRICS[kind]}

    if kind == "serve":
        from drivers import serve as S
        model, server = S.build(ctx)
        loop = S.Loop(server, workload.Requests(
            traffic, config["model"]["vocab_size"], args.seed),
            traffic["clients"])
        S.warm(loop, traffic)
        for on in modes:
            n = len(loop.steps)
            with tracing.recording() if on else contextlib.nullcontext():
                S.window(loop, args.seconds)
            steps = loop.steps[n:]
            windows.append({
                "recording": on, "steps": len(steps),
                "step_ms.decode": _mean([1e3 * (s["t_b"] - s["t_a"])
                                         for s in steps if not s["admitted"]]),
                "step_ms.admit": _mean([1e3 * (s["t_b"] - s["t_a"])
                                        for s in steps if s["admitted"]]),
                "spans": len(tracing.session()["spans"]) if on else 0,
                **program_metrics(on)})
    else:
        from drivers import train as D
        model, step_fn, opt_cfg, pipeline = D.build(ctx)
        params, state, data, _ = D.first_steps(
            model, step_fn, opt_cfg, pipeline, traffic, args.seed, "cuda")
        step = traffic["reference_steps"]
        for on in modes:
            torch.cuda.synchronize()
            t0, n = common.clock(), 0
            with tracing.recording() if on else contextlib.nullcontext():
                while common.clock() < t0 + args.seconds:
                    batch = pipeline.make_global_batch(data, step,
                                                       device="cuda")
                    params, state, _ = step_fn(params, state, batch)
                    step += 1
                    n += 1
                torch.cuda.synchronize()
            windows.append({"recording": on, "steps": n,
                            "step_ms": 1e3 * (common.clock() - t0) / n,
                            "spans": len(tracing.session()["spans"])
                            if on else 0, **program_metrics(on)})
    return {"cell": args.cell, "seed": args.seed, "seconds": args.seconds,
            "card": common.smi_sample(), "windows": windows}


def spans(args, bench):
    import torch
    from repro_torch import tracing
    dev, n = torch.device("cuda"), 20000

    def host():
        with tracing.span("host"):
            pass

    def device():
        with tracing.span("device", dev):
            pass

    def count():
        tracing.count("count")

    out = {"card": common.smi_sample(), "calls": n}
    for on in (False, True):
        with tracing.recording() if on else contextlib.nullcontext():
            for name, fn in (("host_span", host), ("device_span", device),
                             ("count", count)):
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                out[f"{name}_us_{'on' if on else 'off'}"] = \
                    (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    sess = tracing.session()
    out["read_ms"] = (time.perf_counter() - t) * 1e3
    out["spans_read"] = len(sess["spans"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("trace", "cost", "spans"))
    ap.add_argument("cell", nargs="?", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    for var, sub in run.CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {"trace": trace, "cost": cost, "spans": spans}[args.mode](args,
                                                                bench)
    text = json.dumps(out)
    print(text, flush=True)
    dest = ROOT / "chiprun_out" / f"tracing_{args.mode}_{args.cell}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
