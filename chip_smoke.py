#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure (exit 1, no result line):

1. Device: the card's name and power limit; the CUDA kernels are built
   from the sources in the checkout (nvcc, sm_90a) and the build time shown.
2. Kernel vs plain: the flash-attention kernel against its plain PyTorch
   version at the serving shapes (B 1 and 4; S 8, 64, 96, 256; H 32, KV 2,
   hd 128; bf16 and f32; causal), with CUDA-event times of the kernel, the
   plain version and PyTorch's SDPA (a yardstick only), beside the bound.
3. Serve glm4-9b at full width and depth (40 layers, bf16, random weights
   from a seeded generator) with the kernel installed at the ``attention``
   site: a BatchedServer (4 slots, max_len 256) answers 8 requests of mixed
   prompt length.  Checks every request's token count, the kernel's launch
   count, and the last-token prefill logits through the kernel against the
   plain version; prints the agreement with generate(), tokens/s and peak
   memory.
4. The kernel against its plain version at every shape the serving run gave
   it, on that run's own inputs (the first call at each (B, S)); then a
   ``kernels`` JSON line (times at the heaviest of those shapes) and the
   result line.

Details of every case go to chiprun_out/chip_smoke.json.
"""
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # f32 outside the tensor cores
# kernel vs plain version, element by element: |got - want| <= atol +
# rtol * |want|, as (rtol, atol).  f32 differs by summation order only
# (seen: <= 1e-6).  In bf16 both compute in f32 and round to bf16, so they
# differ by at most one ulp, <= 2^-7 |want| (seen: 2^-8 at |o| < 0.5); the
# gate allows two ulps, so a kernel off by 2% fails.  atol covers outputs
# near 0, where the ulp is below f32 summation noise.
KERNEL_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -6, 1e-5)}
# last-token logits through the kernel vs the plain version, 40 bf16 layers,
# relative to the logits' largest magnitude
LOGITS_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(B, S, T, H, KV, hd, dtype: str, causal: bool):
    """(bound_ms, bound_by): the larger of bytes over HBM rate (q, k, v read
    once, o written once) and FLOPs over the peak for the input type
    (QK^T and PV over the kept query/key pairs)."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = S * (S + 1) // 2 if causal else S * T
    flops = 4 * hd * B * H * pairs
    nbytes = item * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_split(fn, reps: int = 3, top: int = 6):
    """Where one call of ``fn`` spends its time: host wall ms (synchronised,
    no profiler), device ms summed over its kernels in a torch.profiler
    trace, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = [(e.key, e.device_time_total / reps / 1e3) for e in dev]
    device_ms = sum(ms for _, ms in kern)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_call": sum(e.count for e in dev) / reps,
            "top_kernels": [{"kernel": k[:90], "ms": ms} for k, ms in
                            sorted(kern, key=lambda x: -x[1])[:top]]}


def compare(q, k, v, causal=True):
    """Kernel vs plain version on the same inputs.  ``tol_ratio`` is the
    largest |got - want| / (atol + rtol |want|): the kernel agrees when it is
    at most 1 and the output is finite."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal).float()
    diff = (got.float() - want).abs()
    B, S, H, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    rtol, atol = KERNEL_TOL[dtype]
    return {
        "B": B, "S": S, "T": k.shape[1], "H": H, "KV": k.shape[2], "hd": hd,
        "dtype": dtype, "causal": causal,
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": diff.max().item(),
        "max_rel_err": (diff.max() / want.abs().max()).item(),
        "tol_ratio": (diff / (atol + rtol * want.abs())).max().item(),
    }


def agrees(r) -> bool:
    return r["finite"] and r["tol_ratio"] <= 1.0


def measure_attention(q, k, v, causal=True):
    """Kernel vs plain version on the same inputs: errors and times."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    r = compare(q, k, v, causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = attention_bound(r["B"], r["S"], r["T"], r["H"],
                                         r["KV"], r["hd"], r["dtype"], causal)
    return {
        **r,
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal)),
        # None where the profiler trace caught no kernel (not measured)
        "kernel_device_ms": time_split(
            lambda: flash_attention(q, k, v, causal=causal))["device_ms"]
        or None,
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                        causal=causal)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_device(report):
    import torch
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library("flash_attention")
    info = build.build_info["flash_attention"]
    print(f"kernel build: flash_attention.cu nvcc {info['seconds']:.2f} s, "
          f"build+load {time.perf_counter() - t0:.2f} s", flush=True)
    for line in str(info["ptxas"]).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:" + line.split(":", 1)[-1].rstrip(), flush=True)
    report["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__,
                        "build_s": info["seconds"]}
    return name, smi


def phase_kernel(report):
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    print("kernel vs plain (flash_attention, causal, H 32, KV 2, hd 128):",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 4):
            for S in (8, 64, 96, 256):
                q = torch.randn(B, S, 32, 128, device="cuda", generator=g)
                k = torch.randn(B, S, 2, 128, device="cuda", generator=g)
                v = torch.randn(B, S, 2, 128, device="cuda", generator=g)
                r = measure_attention(q.to(dtype), k.to(dtype), v.to(dtype))
                rows.append(r)
                print(f"  {r['dtype']:8s} B={B} S={S:3d}  max_abs_err "
                      f"{r['max_abs_err']:.3g} (of tol {r['tol_ratio']:.2f})  "
                      f"kernel {r['ms']:.4f} ms "
                      f"(device {r['kernel_device_ms'] or float('nan'):.4f})  "
                      f"plain {r['plain_ms']:.4f} ms  sdpa "
                      f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} "
                      f"ms ({r['bound_by']})", flush=True)
                if not agrees(r):
                    fail(f"kernel disagrees with its plain version: {r}")
    report["kernel_vs_plain"] = rows


def phase_serve(report):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.models import get_model
    from repro_torch.serve import BatchedServer, generate

    cfg = get_config("glm4-9b")
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"glm4-9b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params:,} params ({cfg.param_dtype}) initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    expect = cfg.param_counts()[0] + cfg.d_model   # param_counts omits final_ln
    if n_params != expect:
        fail(f"parameter count {n_params} != {expect} from the config")

    # the site impl: the kernel wrapper, keeping the inputs of its first
    # call at each (B, S) to hold against the plain version after the run
    first_calls = {}

    def site(q, k, v, *, causal=True, softcap=0.0):
        first_calls.setdefault((q.shape[0], q.shape[1]), (q, k, v, causal))
        return flash_attention(q, k, v, causal=causal, softcap=softcap)

    ops.install("attention", site, kernel="flash_attention", route="cuda")

    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 201, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths]
    max_new = 16

    warm = BatchedServer(model, slots=4, max_len=256)     # cuBLAS, allocator
    for p in prompts[:2]:
        warm.submit(p[:16], max_new=2)
    warm.run()

    stats = {"prefill_calls": 0, "prefill_s": 0.0, "decode_s": 0.0}
    real_prefill, real_decode = model.prefill, model.decode_step

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stats[key] += time.perf_counter() - t
            if key == "prefill_s":
                stats["prefill_calls"] += 1
            return out
        return call

    model.prefill = timed(real_prefill, "prefill_s")
    model.decode_step = timed(real_decode, "decode_s")
    srv = BatchedServer(model, slots=4, max_len=256)
    reqs = [srv.submit(p, max_new=max_new) for p in prompts]
    first_calls.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0                 # the main path's run
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    shapes = dict(first_calls)                   # the main path's shapes
    peak = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step         # back to the class methods

    bad = [(r.rid, len(r.tokens)) for r in reqs
           if not r.done or len(r.tokens) != max_new]
    if bad:
        fail(f"requests without their {max_new} tokens: {bad}")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        fail("a token outside the vocabulary")
    need = cfg.n_layers * stats["prefill_calls"]
    print(f"served {len(reqs)} requests (prompt lengths {lengths.tolist()}) "
          f"in {wall:.2f} s: {stats['prefill_calls']} packed prefills, "
          f"flash_attention launches {launches} (>= {need} needed), "
          f"swap epochs {srv.swap_epochs}", flush=True)
    if launches < need or launches == 0:
        fail(f"the kernel ran {launches} times, {need} expected")

    prefill_tokens = int(lengths.sum())
    decode_tokens = sum(len(r.tokens) - 1 for r in reqs)
    serve = {
        "requests": len(reqs), "prompt_lengths": lengths.tolist(),
        "max_new": max_new, "slots": 4, "max_len": 256,
        "prefill_calls": stats["prefill_calls"], "launches": launches,
        "prefill_tokens": prefill_tokens, "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": prefill_tokens / stats["prefill_s"],
        "decode_tokens": decode_tokens, "decode_s": stats["decode_s"],
        "decode_tokens_per_s": decode_tokens / stats["decode_s"],
        "wall_s": wall, "peak_memory_bytes": peak,
    }
    print(f"prefill {serve['prefill_tokens_per_s']:.1f} tokens/s "
          f"({prefill_tokens} prompt tokens in {stats['prefill_s']:.3f} s), "
          f"decode {serve['decode_tokens_per_s']:.1f} tokens/s "
          f"({decode_tokens} tokens in {stats['decode_s']:.3f} s), peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)

    # last-token prefill logits through the kernel vs its plain version
    p0 = torch.as_tensor(prompts[0], dtype=torch.long, device="cuda")[None]
    with torch.no_grad():
        lk, _ = model.prefill(p0)
        with ops.use_impl("attention", flash_attention_ref):
            lr, _ = model.prefill(p0)
    if not (torch.isfinite(lk).all() and lk.shape == (1, 1, cfg.vocab_size)):
        fail(f"prefill logits not finite or of shape {tuple(lk.shape)}")
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    same_top = int(lk.argmax()) == int(lr.argmax())
    print(f"prefill logits (prompt of {len(prompts[0])}) kernel vs plain: "
          f"max rel err {rel:.3g} (tol {LOGITS_RTOL}), same argmax "
          f"{same_top}", flush=True)
    if rel > LOGITS_RTOL:
        fail(f"prefill logits through the kernel differ by {rel:.3g}")

    agree = sum(r.tokens == [int(t) for t in generate(
        model, r.prompt[None], max_new=max_new)[0]] for r in reqs)
    print(f"requests equal to generate() on the card: {agree}/{len(reqs)} "
          "(bf16 at other row counts is not bit-stable; not gated)",
          flush=True)
    serve.update(logits_rel_err=rel, logits_same_argmax=same_top,
                 generate_agreement=agree / len(reqs))

    # where a serving step's time goes (outside the counted run): one
    # ragged decode step over 4 live slots, one packed prefill of two
    # 256-token rows
    cache = model.init_cache(4, 256)
    toks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([200, 150, 100, 50], device="cuda")
    rows = torch.as_tensor(np.stack([prompts[0][:160]] * 2), device="cuda")
    rows = torch.nn.functional.pad(rows.long(), (0, 96))
    lens = torch.tensor([160, 160], device="cuda")
    with torch.no_grad():
        split = {"decode_step": time_split(
                     lambda: model.decode_step(cache, toks, pos)),
                 "prefill_2x256": time_split(
                     lambda: model.prefill(rows, max_len=256, lengths=lens))}
    for what, r in split.items():
        print(f"{what}: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms (busy {r['device_busy_share']:.1%}) "
              f"in {r['kernels_per_call']:.0f} kernels;"
              " top: " + ", ".join(f"{t['kernel'][:40]} {t['ms']:.3f}"
                                   for t in r["top_kernels"][:3]), flush=True)
    serve["time_split"] = split
    report["serve"] = serve
    ops.clear_all()
    return launches, shapes


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: run "
             "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report = {}
    t_start = time.perf_counter()
    name, smi = phase_device(report)
    phase_kernel(report)
    launches, shapes = phase_serve(report)

    print("kernel vs plain at the serving run's shapes, on its inputs:",
          flush=True)
    checks = []
    for (B, S), (q, k, v, causal) in sorted(shapes.items()):
        r = compare(q, k, v, causal)
        checks.append(r)
        print(f"  {r['dtype']:8s} B={B} S={S:3d}  max_abs_err "
              f"{r['max_abs_err']:.3g} (of tol {r['tol_ratio']:.2f})",
              flush=True)
        if not agrees(r):
            fail(f"kernel disagrees at the serving run's shape: {r}")
    report["main_path_checks"] = checks
    q, k, v, causal = max(shapes.values(), key=lambda a: (
        a[0].shape[0] * a[0].shape[1] * a[1].shape[1]))
    main_shape = measure_attention(q, k, v, causal=causal)
    if not agrees(main_shape):
        fail(f"kernel disagrees at the serving run's shape: {main_shape}")
    report["main_path_shape"] = main_shape
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(f"flash_attention at the serving run's heaviest shape "
          f"(B={main_shape['B']}, S={main_shape['S']}, {main_shape['dtype']}); "
          f"all phases passed in {report['seconds']:.1f} s; details in "
          f"{OUT.relative_to(ROOT)}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
