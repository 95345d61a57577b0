"""Phase 22 of ``chip_smoke.py`` (the launch layer's dry run) alone, on one
GPU.

Runs the build (phase 1) first, then phase 19 (training, whose step and
prefill phase 22 reads), then phase 22: the production dry run of
whisper-medium x decode_32k and stablelm-3b x train_4k in processes of
their own, and stablelm-3b's train step and prefill counted and held
against their measured times.  Writes phase 22's report to
``chiprun_out/probe22.json``.

    python3 probes/phase22.py        # from the repository root
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
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    report = {}
    t = time.perf_counter()
    cs.phase_device(report)
    cs.phase_training(report)
    t22 = time.perf_counter()
    runs = cs.start_dryruns()
    try:
        cs.phase_dryrun(report, runs, t22)
    finally:
        cs.stop_dryruns(runs)
    print(f"phase 22 {time.perf_counter() - t22:.1f} s", flush=True)
    out = ROOT / "chiprun_out" / "probe22.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report["dryrun"], indent=1, default=str))
    print(f"probe: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
