"""How steady are the interference control's quiet one-call reps?  On one
GPU: gemm's phase-20 winner (128^3 tiles, f32, fused) at scale 1024
through K1, read as ``chip_smoke.interference_control`` reads it (5
rounds, each the median of RETIME_REPS one-call reps and one window of
WINDOW_CALLS calls), with two local-cluster workers and the control's
second context alive but idle, as in phase 20.  Each trial follows a
0.3 s idle gap on the card and uses one of these procedures:

* as_is     -- one untimed call, then the 5 rounds;
* one_round -- one untimed round first (its readings dropped);
* busy      -- 0.2 s of calls back to back, then one untimed round;
* reps150   -- as_is with 150 one-call reps a round;
* pinned    -- as_is with this process on one CPU core and no garbage
               collection while it reads;
* pinned150 -- both;
* spaced3   -- as_is with the round's reps 3 ms apart (the host sleeps;
               the control's reading since ``chip_smoke.REP_GAP_S``);
* spaced10  -- the same, 10 ms apart.

Then the second context loops K1 and 2 loaded trials of each procedure
are read.  Prints each trial's rep rounds, their spread, and whether the
control's rep gate (loaded beyond the quiet spread, either way) holds
against the loaded readings of the same procedure; writes everything to
``chiprun_out/probe_rep.json``.  PROBE_TRIALS (default 10) sets the
quiet trials of each procedure.

    python3 probes/interference_rep.py [procedure ...]   # default: all
"""
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

TRIALS = int(os.environ.get("PROBE_TRIALS", 10))


def main() -> None:
    import numpy as np
    import torch
    from repro_torch.core import LocalClusterExecutor, datagen, get_case
    from repro_torch.core.fe import as_tensors
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", cs.INTERFERER, str(ROOT / "src"), "60"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    ex = LocalClusterExecutor(2)
    ex._start_all([0, 1])
    case = get_case("gemm")
    variant = {"block_m": 128, "block_n": 128, "block_k": 128,
               "compute_dtype": "f32", "fuse_epilogue": True}
    inputs = as_tensors(datagen.generate(case.input_specs(1024), 0), "cuda")
    fn = case.build(variant, impl="cuda")

    def rounds(reps=cs.RETIME_REPS, gap_s=0.0):
        rep, window, host = [], [], []
        for _ in range(cs.RETIME_ROUNDS):
            rep.append(float(np.median(cs.call_times_ms(fn, inputs, reps,
                                                        gap_s=gap_s))))
            window.append(cs.cuda_ms(lambda: fn(*inputs),
                                     reps=cs.WINDOW_CALLS, warmup=1))
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(cs.RETIME_REPS):
                fn(*inputs)
            host.append((time.perf_counter() - t) / cs.RETIME_REPS * 1e3)
            torch.cuda.synchronize()
        return {"rep": rep, "window": window, "host_ms": host}

    def busy():
        end = time.perf_counter() + 0.2
        while time.perf_counter() < end:
            for _ in range(20):
                fn(*inputs)
            torch.cuda.synchronize()

    cores = sorted(os.sched_getaffinity(0))

    def pinned(reps):
        gc.disable()
        os.sched_setaffinity(0, {cores[-1]})
        try:
            return rounds(reps)
        finally:
            os.sched_setaffinity(0, cores)
            gc.enable()

    # name: (what runs untimed first, how the trial reads)
    procs = {"as_is": (lambda: fn(*inputs), rounds),
             "one_round": (rounds, rounds),
             "busy": (lambda: (busy(), rounds()), rounds),
             "reps150": (lambda: fn(*inputs), lambda: rounds(150)),
             "pinned": (lambda: fn(*inputs), lambda: pinned(cs.RETIME_REPS)),
             "pinned150": (lambda: fn(*inputs), lambda: pinned(150)),
             "spaced3": (lambda: fn(*inputs),
                         lambda: rounds(gap_s=0.003)),
             "spaced10": (lambda: fn(*inputs),
                          lambda: rounds(gap_s=0.010))}
    procs = {k: procs[k] for k in sys.argv[1:] or procs}
    quiet = {k: [] for k in procs}
    with torch.no_grad():
        fn(*inputs)
        torch.cuda.synchronize()
        if child.stdout.readline().strip() != "READY":
            cs.fail("the second context did not start")
        for _ in range(TRIALS):
            for name, (pre, read) in procs.items():
                time.sleep(0.3)
                pre()
                quiet[name].append(read())
        child.stdin.write("GO\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "LOOPING":
            cs.fail("the second context did not loop")
        time.sleep(0.5)
        loaded = {k: [] for k in procs}
        for _ in range(2):
            for name, (_, read) in procs.items():
                time.sleep(0.3)
                loaded[name].append(read())
    cs.stop_child(child)
    ex.close()
    summary = {}
    for name, trials in quiet.items():
        lrep = [x for t in loaded[name] for x in t["rep"]]
        rows = []
        for t in trials:
            q = t["rep"]
            spread = max(q) - min(q)
            rows.append({"spread": spread,
                         "below": max(lrep) < min(q) - spread,
                         "above": min(lrep) > max(q) + spread})
            print(f"{name:9s} rep rounds " + ", ".join(f"{x:.4f}" for x in q)
                  + f" spread {spread:.4f}; host ms a call "
                  + ", ".join(f"{x:.4f}" for x in t["host_ms"])
                  + f"; windows {min(t['window']):.4f}-"
                  f"{max(t['window']):.4f}; gate "
                  f"{rows[-1]['below'] or rows[-1]['above']}", flush=True)
        summary[name] = {"held": sum(r["below"] or r["above"] for r in rows),
                         "trials": len(rows),
                         "median_spread": float(np.median(
                             [r["spread"] for r in rows]))}
    for name, trials in loaded.items():
        for t in trials:
            print(f"loaded {name:9s} rep rounds " + ", ".join(
                f"{x:.4f}" for x in t["rep"]) + "; windows " + ", ".join(
                f"{x:.4f}" for x in t["window"]), flush=True)
    print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out" / "probe_rep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"quiet": quiet, "loaded": loaded,
                               "summary": summary}, indent=1))
    print(f"probe: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
