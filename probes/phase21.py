"""Phase 21 of ``chip_smoke.py`` (the distributed layer) alone, on one GPU.

Runs the build (phase 1) first, then phase 21: K2 with a causal query
offset against its plain version, glm4-9b's context-parallel prefill and
tp_seq decode on two rank processes sharing the card, ``compressed_psum``
on CUDA tensors, the tensor-parallel legs and the sharded train steps,
with phase 22 (a)'s dry runs on the CPU beside it as in the whole script;
then (a)'s device times in a fresh process.  Writes phase 21's report
to ``chiprun_out/probe21.json``.

    python3 probes/phase21.py        # from the repository root
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this probe runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    t = time.perf_counter()
    cs.phase_device(report)
    dryruns = cs.start_dryruns()     # as the whole script runs them beside
    try:
        _, rows = cs.phase_distributed(report)
        cs.finish_dryruns(dryruns)
    finally:
        cs.stop_dryruns(dryruns)
    for (r, _), dev in zip(rows, cs.fresh_device_time(
            [("flash_attention", *call) for _, call in rows])):
        r["kernel_device_ms"] = dev["device_ms"]
        print(f"K2 {r['dtype']} q_offset {r['q_offset']}: device "
              f"{dev['device_ms']:.4f} ms (CUDA events {r['ms']:.4f}), bound "
              f"{r['bound_ms']:.5f}", flush=True)
    out = ROOT / "chiprun_out" / "probe21.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report["distributed"], indent=1, default=str))
    print(f"probe: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
