#!/usr/bin/env python3
"""Times one tree's K1, K3 and K5 on the card at their PERF.md main shapes,
so that two trees can be compared in one call on one card.

    python3 scripts/kernel_ab.py --tree DIR [--label NAME]

``DIR`` is a checkout of this repository (``.`` for this one; another
commit unpacked by ``git archive`` into the git-ignored ``build/``).  Its
``repro_torch`` is imported from ``DIR/src`` and its kernels are built into
``DIR/build/kernels``.  Run the trees in turns, parent, change, change,
parent, each in its own process:

    git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 scripts/kernel_ab.py --tree $t; done

Prints the card's name and power limit, then one JSON line (also appended
to ``chiprun_out/kernel_ab.jsonl``), for each main shape:

* ``ms``: CUDA events, 20 calls a round, the median of 5 rounds, with the
  rounds, and the same for the library call that computes the function
  (``library_ms``: ``torch.sum``, ``torch.bmm``, ``torch.addmm`` with TF32
  off);
* ``device_ms``, ``kernels_per_call``: the kernels' device time and count
  a call in a ``torch.profiler`` trace (this is a fresh process);
* ``host_us_per_call``: 1000 calls without a sync.

and ``components``, the host µs a call of each step of a K3 or K5 launch
that the thin launch path (``kernels/launch.py``) changes, each 10000
calls: ``resolve_device``, K5's tile checks (cached or not; the parent's
are not), the stream handle (``torch.cuda.current_stream``
against ``torch._C._cuda_getCurrentRawStream``), allocating the output
(``torch.empty(1)`` and indexing ``[0]``, against ``new_empty(())``), and
the ctypes call itself, made with arguments that the C entry refuses at
once (n = 0, E = 0), so nothing launches: the tree's own form, eight or
nineteen converted arguments, or one packed struct.

Shapes: K3 n 4,194,304 f32 at each of the ``reduction`` case's blocks
(16384, 4096, 1024); K5 E 8 M 512 K 256 N 512 f32 and bf16 on 128^3; K1
1024^3 f32 alpha*AB + beta*C on 128^3.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]


def us_per_call(fn, calls: int = 10000) -> float:
    fn()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) * 1e6 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import moe_gemm as k5
    from repro_torch.kernels import reduce_sum as k3
    if not str(Path(k3.__file__).resolve()).startswith(str(tree)):
        sys.exit(f"kernel_ab: imported {k3.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    g = torch.Generator(device="cuda").manual_seed(18)
    x3 = torch.randn(4194304, device="cuda", generator=g)
    x5 = torch.randn(8, 512, 256, device="cuda", generator=g)
    w5 = torch.randn(8, 256, 512, device="cuda", generator=g)
    a1, b1, c1 = (torch.randn(1024, 1024, device="cuda", generator=g)
                  for _ in range(3))
    tile = dict(block_m=128, block_n=128, block_k=128)
    shapes = {
        f"reduce_sum n 4194304 f32 block {blk}": (
            lambda blk=blk: k3.reduce_sum(x3, block=blk),
            lambda: torch.sum(x3))
        for blk in (16384, 4096, 1024)}        # the reduction case's blocks
    shapes.update({
        "grouped_matmul E 8 M 512 K 256 N 512 f32 128^3": (
            lambda: k5.grouped_matmul(x5, w5, **tile),
            lambda: torch.bmm(x5, w5)),
        "matmul 1024^3 f32 alpha_beta 128^3": (
            lambda: k1.matmul(a1, b1, c1, epilogue="alpha_beta", alpha=1.5,
                              beta=1.2, **tile),
            lambda: torch.addmm(c1, a1, b1, beta=1.2, alpha=1.5)),
    })
    x5b, w5b = x5.bfloat16(), w5.bfloat16()
    shapes["grouped_matmul E 8 M 512 K 256 N 512 bf16 128^3"] = (
        lambda: k5.grouped_matmul(x5b, w5b, **tile),
        lambda: torch.bmm(x5b, w5b))
    out = {}
    for name, (fn, lib) in shapes.items():
        r = cs.alternated({"ms": fn, "library_ms": lib})
        split = cs.time_split(fn, reps=10)
        r.update(device_ms=split["device_ms"],
                 kernels_per_call=split["kernels_per_call"],
                 host_us_per_call=cs.host_us_per_call(fn))
        out[name] = r
        print(f"  {name}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{r['kernels_per_call']:g} kernels a call; host "
              f"{r['host_us_per_call']:.1f} us a call); library "
              f"{r['library_ms']:.4f}", flush=True)

    dev = torch.device("cuda", 0)
    o = torch.empty(1, device=dev)
    comp = {"resolve_device": us_per_call(lambda: resolve_device("cuda")),
            "current_stream": us_per_call(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "raw_stream": us_per_call(
                lambda: torch._C._cuda_getCurrentRawStream(0)),
            "empty_1": us_per_call(lambda: torch.empty(
                1, dtype=torch.float32, device=dev)),
            "index_0": us_per_call(lambda: o[0]),
            "new_empty_0d": us_per_call(lambda: x3.new_empty(()))}
    if hasattr(k5._tile, "__wrapped__"):    # K5's checks, cached or not
        sx, sw = tuple(x5.shape), tuple(w5.shape)
        comp["k5_tile_checks_cached"] = us_per_call(lambda: k5._tile(
            x5.shape, w5.shape, x5.dtype, w5.dtype, 128, 128, 128))
        comp["k5_tile_checks"] = us_per_call(lambda: k5._tile.__wrapped__(
            sx, sw, x5.dtype, w5.dtype, 128, 128, 128))
    if hasattr(k3, "_ENTRY"):               # one packed struct
        comp["k3_ctypes_refused"] = us_per_call(lambda: k3._ENTRY(
            0, 0, 0, 0, 0, 0, 0, 1))
        comp["k5_ctypes_refused"] = us_per_call(lambda: k5._ENTRY(*[0] * 20))
    else:                                   # converted arguments
        comp["k3_ctypes_refused"] = us_per_call(
            lambda: k3._lib().reduce_sum_forward(0, 0, 0, 0, 0, 0, 1, 0))
        comp["k5_ctypes_refused"] = us_per_call(
            lambda: k5._lib().gmm_forward(*[0] * 19))
    print("  host us a call: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in comp.items()),
          flush=True)
    line = {"label": args.label or str(Path(args.tree)), "nvidia_smi": smi,
            "kernels": out, "components": comp}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
