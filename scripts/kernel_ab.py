#!/usr/bin/env python3
"""Times one tree's K1, K3, K4, K5, K6 and K7 on the card at their PERF.md
main shapes, so that two trees can be compared in one call on one card.

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
* ``host_us_per_call``: 1000 calls without a sync;
* K6 also ``state_sha256``, the SHA-256 of its final state's bytes, so
  that two trees' states can be compared bit for bit (the inputs come from
  one seeded generator);
* K7 also ``max_abs_err`` and ``state_max_abs_err``, its largest errors
  against its plain version on the same seeded input, so that two trees'
  arithmetic can be read side by side.

and ``components``, the host µs a call of each step of a K3, K4, K5, K6 or
K7 launch that the thin launch path (``kernels/launch.py``) or K4's cached
launch changes, each 10000 calls: ``resolve_device``, K5's tile checks
(cached or not; the parent's are not), the stream handle
(``torch.cuda.current_stream`` against
``torch._C._cuda_getCurrentRawStream``), allocating the output
(``torch.empty(1)`` and indexing ``[0]``, against ``new_empty(())``), the
ctypes call itself, made with arguments that the C entry refuses at once
(n = 0, E = 0, B = 0), so nothing launches: the tree's own form, eight,
nineteen, 25 or 28 converted arguments, or one packed struct; K7's shape
checks and its ``a_log`` conversion; and K4's steps:
its checks, ``fit``, the ``_compile`` lookup, ``torch.empty_like``, the
``torch.cuda.device`` context, ``JITFunction.run`` (a whole launch through
Triton's own path, 2000 calls) and, where the tree caches the compiled
kernel, the launch key and the bare launch through its launcher.

Shapes: K3 n 4,194,304 f32 at each of the ``reduction`` case's blocks
(16384, 4096, 1024); K5 E 8 M 512 K 256 N 512 f32 and bf16 on 128^3; K1
1024^3 f32 alpha*AB + beta*C on 128^3; K4 ``vectoradd``'s map at n
16,777,216 and 262,144 (its largest and smallest scales) f32, block 8192;
K6 rwkv6-7b's B=1 S=256 H=64 K=V=64 bf16, chunk 128, and the Table 4
case's B=2 S=1024 H=8 f32, chunk 64; K7 hymba-1.5b's B=1 S=256 H=50 P=64
N=16 bf16, chunk 128 (a_log in f32, as the wrapper hands it over), and the
``mamba_ssd`` case's B=2 S=1024 H=8 f32, chunk 128.
"""
import argparse
import hashlib
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


def fields(entry) -> int:
    """The 8-byte fields of a packed launch entry (``launch.Entry``)."""
    return entry.pack.__self__.size // 8


def k4_components(k4, fn, resolve_device):
    """Host µs a call of each step of a K4 launch in the tree's own form,
    at n 262,144 f32, block 8192 (32 programs: the device outruns the host,
    so no step waits on a full launch queue)."""
    import torch
    n = 262144
    a, b = (torch.randn(n, device="cuda") for _ in range(2))
    o = torch.empty_like(a)
    kernel, fn_jit = k4._compile(fn)

    def context():
        with torch.cuda.device(a.device):
            pass
    comp = {"k4_resolve_device": us_per_call(lambda: resolve_device("cuda")),
            "k4_checks": us_per_call(lambda: k4._check((a, b))),
            "k4_fit": us_per_call(lambda: k4.fit(8192, n)),
            "k4_compile_lookup": us_per_call(lambda: k4._compile(fn)),
            "k4_empty_like": us_per_call(lambda: torch.empty_like(a)),
            "k4_device_context": us_per_call(context),
            "k4_jitfunction_run": us_per_call(lambda: kernel[(n // 8192,)](
                o, a, b, a, 8192, FN=fn_jit, N_IN=2, BLOCK=8192,
                num_warps=8)),
            "k4_wrapper": us_per_call(lambda: k4.elementwise(fn, a, b,
                                                             block=8192))}
    if hasattr(k4, "_launches"):            # the cached compiled kernel
        tensors = (o, a, b, a)
        entry = k4._launches[k4.launch_key(fn, 2, tensors, 8192, 8192, 8)]
        args = k4.launch_args(entry, n // 8192, k4.raw_stream(0), tensors,
                              8192, 2, 8192)
        run = entry[0]
        comp["k4_grid_cached"] = us_per_call(lambda: k4._grid(8192, n))
        comp["k4_launch_key"] = us_per_call(lambda: k4.launch_key(
            fn, 2, tensors, 8192, 8192, 8))
        comp["k4_launch_args"] = us_per_call(lambda: k4.launch_args(
            entry, n // 8192, k4.raw_stream(0), tensors, 8192, 2, 8192))
        comp["k4_bare_launch"] = us_per_call(lambda: run(*args))
    torch.cuda.synchronize()
    return comp


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
    from repro_torch.kernels import elementwise as k4
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import rwkv_wkv as k6
    from repro_torch.kernels import moe_gemm as k5
    from repro_torch.kernels import reduce_sum as k3
    from repro_torch.kernels import ssd_scan as k7
    from repro_torch.kernels.suites.appsdk import _add
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
    a4, b4 = (torch.randn(16777216, device="cuda", generator=g)
              for _ in range(2))
    shapes["elementwise add n 16777216 f32 block 8192"] = (
        lambda: k4.elementwise(_add, a4, b4, block=8192),
        lambda: torch.add(a4, b4))
    a4s, b4s = a4[:262144], b4[:262144]        # vectoradd's smallest scale
    shapes["elementwise add n 262144 f32 block 8192"] = (
        lambda: k4.elementwise(_add, a4s, b4s, block=8192),
        lambda: torch.add(a4s, b4s))
    wkv_args = cs.recurrent_inputs("wkv", 1, 256, torch.bfloat16, g)
    shapes["wkv B 1 S 256 H 64 K 64 V 64 bf16 chunk 128"] = (
        lambda: k6.wkv(*wkv_args, chunk=128), None)
    # the Table 4 case (kernels/suites/hpc.py) at its largest scale
    r6, k6_, v6 = (0.5 * torch.randn(2, 1024, 8, 64, device="cuda",
                                     generator=g) for _ in range(3))
    lw6 = -torch.rand(2, 1024, 8, 64, device="cuda", generator=g) * 3 - 0.01
    u6 = 0.5 * torch.randn(8, 64, device="cuda", generator=g)
    shapes["wkv B 2 S 1024 H 8 K 64 V 64 f32 chunk 64"] = (
        lambda: k6.wkv(r6, k6_, v6, lw6, u6, chunk=64), None)
    ssd_args = cs.recurrent_inputs("ssd", 1, 256, torch.bfloat16, g)
    shapes["ssd B 1 S 256 H 50 P 64 N 16 bf16 chunk 128"] = (
        lambda: k7.ssd(*ssd_args, chunk=128), None)
    # the mamba_ssd case (kernels/suites/hpc.py) at its largest scale
    bc7 = torch.randn(2, 1024, 32, device="cuda", generator=g)
    case_args = (torch.randn(2, 1024, 8, 64, device="cuda", generator=g),
                 torch.rand(2, 1024, 8, device="cuda", generator=g) * 0.1
                 + 0.001,
                 torch.rand(8, device="cuda", generator=g) * 2 - 1,
                 bc7[..., :16].contiguous(), bc7[..., 16:].contiguous())
    shapes["ssd B 2 S 1024 H 8 P 64 N 16 f32 chunk 128"] = (
        lambda: k7.ssd(*case_args, chunk=128), None)
    ssd_inputs = {"ssd B 1 S 256 H 50 P 64 N 16 bf16 chunk 128": ssd_args,
                  "ssd B 2 S 1024 H 8 P 64 N 16 f32 chunk 128": case_args}
    out = {}
    for name, (fn, lib) in shapes.items():
        r = cs.alternated({"ms": fn, **({"library_ms": lib} if lib else {})})
        split = cs.time_split(fn, reps=10)
        r.update(device_ms=split["device_ms"],
                 kernels_per_call=split["kernels_per_call"],
                 host_us_per_call=cs.host_us_per_call(fn))
        if name.startswith("wkv"):
            state = fn()[1].cpu().numpy()
            r["state_sha256"] = hashlib.sha256(state.tobytes()).hexdigest()
        if name.startswith("ssd"):
            y, state = fn()
            want_y, want_s = k7.ssd_plain(*ssd_inputs[name], chunk=128)
            r["max_abs_err"] = (y.float() - want_y.float()).abs().max().item()
            r["state_max_abs_err"] = (state - want_s).abs().max().item()
        out[name] = r
        print(f"  {name}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{r['kernels_per_call']:g} kernels a call; host "
              f"{r['host_us_per_call']:.1f} us a call); library "
              + (f"{r['library_ms']:.4f}" if lib else "none")
              + (f"; state sha256 {r['state_sha256']}"
                 if "state_sha256" in r else "")
              + (f"; max_abs_err {r['max_abs_err']:.3g}, state "
                 f"{r['state_max_abs_err']:.3g}" if "max_abs_err" in r
                 else ""), flush=True)

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
    if hasattr(k6, "_ENTRY"):
        comp["k6_ctypes_refused"] = us_per_call(lambda: k6._ENTRY(
            *[0] * fields(k6._ENTRY)))
    else:
        comp["k6_ctypes_refused"] = us_per_call(
            lambda: k6._lib().wkv_forward(*[0] * 28))
    xh7 = ssd_args[0]
    a_log7 = ssd_args[2]
    comp["k7_checks"] = us_per_call(lambda: k7._check(*ssd_args, 128))
    comp["k7_a_log_float"] = us_per_call(lambda: a_log7.float().contiguous())
    comp["k7_outputs"] = us_per_call(lambda: (
        xh7.new_empty(xh7.shape), xh7.new_empty((1, 50, 64, 16),
                                                dtype=torch.float32)))
    if hasattr(k7, "_ENTRY"):
        comp["k7_ctypes_refused"] = us_per_call(lambda: k7._ENTRY(
            *[0] * fields(k7._ENTRY)))
    else:
        comp["k7_ctypes_refused"] = us_per_call(
            lambda: k7._lib().ssd_forward(*[0] * 25))
    comp.update(k4_components(k4, _add, resolve_device))
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
