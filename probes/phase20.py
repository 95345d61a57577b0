"""Phase 20 of ``chip_smoke.py`` (the campaign fabric) alone, on one GPU.

Runs the phases it needs first: the build (phase 1) and phase 5's
in-process campaign, whose winners phase 20 is held against.  Writes
phase 20's report to ``chiprun_out/probe20.json``.

    python3 probes/phase20.py        # from the repository root
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
    cs.phase_campaign(report)
    cs.phase_fabric(report)
    out = ROOT / "chiprun_out" / "probe20.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report["fabric"], indent=1, default=str))
    print(f"probe: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
