"""Does a second process on the card move eq. 3 timings taken under the
device lease?  On one GPU: 2mm's winner (128^3 tiles, f32, fused) at scale
768 timed by the ``h100`` platform (R 30, k 3, the adaptive engine) 8
times in each condition, each timing inside a hold of the card's lease:

* alone      -- nothing else on the card;
* cpu        -- a second process spins numpy on the host, no CUDA;
* idle_ctx   -- a second process holds a CUDA context, idle;
* alternate  -- a second process takes the lease in turns (20 K1 launches
                a hold, a short host gap between), as a fabric worker does;

then alone again.  Prints each condition's trimmed means and CIs (ms) and
writes them to ``chiprun_out/probe_alt.json``.

    python3 probes/lease_interference.py      # from the repository root
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CHILD = r'''
import sys, time
sys.path.insert(0, sys.argv[1])
mode = sys.argv[2]
import numpy as np
if mode == "cpu":
    print("READY", flush=True)
    end = time.monotonic() + 60
    a = np.random.rand(400, 400)
    while time.monotonic() < end:
        a = a @ a
        a /= np.abs(a).max()
    sys.exit(0)
import torch
from repro_torch.core.measure import card_key, get_device_lease
from repro_torch.kernels.matmul import matmul
lease = get_device_lease(card_key("cuda"), device="cuda")
with lease.hold("control"):
    a = torch.randn(1024, 1024, device="cuda")
    b = torch.randn(1024, 1024, device="cuda")
    matmul(a, b)
print("READY", flush=True)
end = time.monotonic() + 60
while time.monotonic() < end:
    if mode == "idle_ctx":
        time.sleep(0.05)
        continue
    with lease.hold("control"):
        for _ in range(20):
            matmul(a, b)
    np.random.rand(200000).sum()          # a short host gap
'''


def main() -> None:
    import numpy as np
    import torch
    from repro_torch.core import (H100Platform, MeasureConfig, datagen,
                                  get_case)
    from repro_torch.core.measure import card_key, get_device_lease

    torch.backends.cuda.matmul.allow_tf32 = False
    case = get_case("2mm")
    variant = {"block_m": 128, "block_n": 128, "block_k": 128,
               "compute_dtype": "f32", "fuse_epilogue": True}
    platform = H100Platform()
    inputs = datagen.generate(case.input_specs(768), 0)
    lease = get_device_lease(card_key("cuda"), device="cuda")

    def run(label, n=8):
        out = []
        for _ in range(n):
            with lease.hold("time"):
                t = platform.time_variant(case, variant, 768, inputs, r=30,
                                          k=3, budget=MeasureConfig())
            out.append((t.trimmed_mean_s * 1e3, t.ci_half_width_s * 1e3,
                        t.r))
        ms = [o[0] for o in out]
        print(f"{label:10s} trimmed means {np.median(ms):.4f} ms (min "
              f"{min(ms):.4f} max {max(ms):.4f}); CIs "
              f"{[round(o[1], 4) for o in out]}; reps "
              f"{[o[2] for o in out]}", flush=True)
        return out

    res = {}
    run("warm", 2)
    res["alone"] = run("alone")
    for mode in ("cpu", "idle_ctx", "alternate"):
        child = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(ROOT / "src"), mode],
            stdout=subprocess.PIPE, text=True)
        if child.stdout.readline().strip() != "READY":
            raise SystemExit(f"the {mode} process did not start")
        time.sleep(0.3)
        try:
            res[mode] = run(mode)
        finally:
            child.kill()
            child.wait()
    res["alone_again"] = run("alone2")
    out = ROOT / "chiprun_out" / "probe_alt.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res))


if __name__ == "__main__":
    main()
