#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure (exit 1, no result line):

1. Device: the card's name and power limit; both CUDA kernels (K2 flash
   attention and K1 tiled GEMM) are built from the sources in the checkout
   (nvcc, sm_90a, one nvcc per source, started together) and the build
   times shown.  A failed build is fatal.
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
   it, on that run's own inputs (the first call at each (B, S)).
5. The paper's pipeline on the card: a ``Campaign`` on the measured ``h100``
   platform with the heuristic proposer over the PolyBench matmul family
   (gemm, 2mm, 3mm, syrk, syr2k), every candidate FE-checked and timed
   through K1 (CUDA events).  Prints each case's MEP scale, baseline → best
   speedup, FE and AER counts and K1 launches; every case must launch K1
   and reach at least one ``ok`` candidate.
6. K1 against its plain version at every (shape, epilogue, dtype, tile,
   layout) the campaign gave it, on the campaign's own inputs (the first
   call at each), with times at every shape and the bound, the plain
   version and ``torch.addmm`` (a yardstick only) at the main shape: gemm's
   winner at gemm's MEP scale.  The profiler's device time of K1 there and
   of K2 at phase 4's shape is taken after phase 7 in a fresh process
   (``--device-time``), where traces keep every kernel.
7. ``optimize`` of ``attention_prefill`` on ``h100`` (every variant runs
   K2), then its ``integrated_speedup`` into full-width glm4-9b over 2×256
   tokens: the naive plain-PyTorch attention against the winner's ``cuda``
   build (K2) at the ``attention`` site, in float32, the dtype the case is
   optimized in.  Prints the speedup and ``fe_ok`` (must be true); K2 is
   held against its plain version at every shape this phase gave it.
   Then the ``kernels`` JSON line (K1 and K2) and the result line.

Details of every case go to chiprun_out/chip_smoke.json.
"""
import json
import re
import subprocess
import sys
import time
import warnings
from typing import Optional
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
KERNEL_SOURCES = ("flash_attention", "matmul")
MATMUL_CASES = ("gemm", "2mm", "3mm", "syrk", "syr2k")


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


def time_split(fn, reps: int = 3, top: int = 6,
               kernels_per_call: Optional[int] = None):
    """Where one call of ``fn`` spends its time: host wall ms (synchronised,
    no profiler), device ms summed over its kernels in a torch.profiler
    trace, and the kernels with the most device time.

    Late in a process that has traced thousands of kernels, a trace can
    lose the kernels launched first in it, at times all of ``fn``'s (seen
    on the H100 with torch 2.11 after the serving phase).  So each trace
    opens with four sentinel kernels (``torch.cuda._sleep``), left out of
    the sums; ``sentinels_lost`` counts the missing ones.  With
    ``kernels_per_call`` the trace must hold exactly that many of ``fn``'s
    kernels per call, else it is taken again, at most three times, and
    then fails; such single-kernel times are taken in a fresh process
    (``fresh_device_time``)."""
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
    sentinels_lost = 0
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        sentinels_lost += 4 - sum(e.count for e in dev
                                  if "spin_kernel" in e.key)
        dev = [e for e in dev if "spin_kernel" not in e.key]
        n_kernels = sum(e.count for e in dev)
        if kernels_per_call is None or n_kernels == reps * kernels_per_call:
            break
    else:
        fail(f"the profiler trace holds {n_kernels} kernels of {reps} calls,"
             f" not {kernels_per_call} a call, in three tries: {dev}")
    kern = [(e.key, e.device_time_total / reps / 1e3) for e in dev]
    device_ms = sum(ms for _, ms in kern)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_call": n_kernels / reps, "traces": attempt + 1,
            "sentinels_lost": sentinels_lost,
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


def measure_attention(q, k, v, causal=True, device_time=True):
    """Kernel vs plain version on the same inputs: errors and times (the
    profiler's device time of the kernel only with ``device_time``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    r = compare(q, k, v, causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = attention_bound(r["B"], r["S"], r["T"], r["H"],
                                         r["KV"], r["hd"], r["dtype"], causal)
    if device_time:
        split = time_split(lambda: flash_attention(q, k, v, causal=causal),
                           kernels_per_call=1)
        r["kernel_device_ms"] = split["device_ms"]
        r["kernel_trace"] = {key: split[key]
                             for key in ("traces", "sentinels_lost")}
    return {
        **r,
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal)),
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
    # one nvcc per source, all started together; a failed build is fatal
    t0 = time.perf_counter()
    try:
        build.build(*KERNEL_SOURCES)
    except Exception as e:
        fail(f"building the kernels failed: {e}")
    print(f"kernel build: {len(KERNEL_SOURCES)} sources in parallel, "
          f"build+load {time.perf_counter() - t0:.2f} s", flush=True)
    for src in KERNEL_SOURCES:
        info = build.build_info[src]
        print(f"  {src}.cu: nvcc {info['seconds']:.2f} s", flush=True)
        for line in str(info["ptxas"]).splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:" + line.split(":", 1)[-1].rstrip(),
                      flush=True)
    report["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__,
                        "build_s": {n: build.build_info[n]["seconds"]
                                    for n in KERNEL_SOURCES}}
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
                      f"(device {r['kernel_device_ms']:.4f})  "
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
              f"in {r['kernels_per_call']:.0f} kernels ({r['traces']} traces, "
              f"{r['sentinels_lost']} sentinels lost);"
              " top: " + ", ".join(f"{t['kernel'][:40]} {t['ms']:.3f}"
                                   for t in r["top_kernels"][:3]), flush=True)
    serve["time_split"] = split
    report["serve"] = serve
    ops.clear_all()
    return launches, shapes


# --------------------------------------------------------------------------
# the MEP pipeline on the card (phases 5-7)
# --------------------------------------------------------------------------
class FirstCalls:
    """Wraps a kernel wrapper where a module looks it up (``module.attr``),
    passing every call on to the wrapper, whose launch counter counts as
    before, and keeping the arguments of the first call at each
    ``key(*args, **kw)`` that launched (a call the wrapper refuses, such
    as a tile that automatic error repair then shrinks, is not kept).
    ``restore`` puts the wrapper back."""

    def __init__(self, module, attr, key):
        self.module, self.attr = module, attr
        self.real = getattr(module, attr)
        self.calls = {}

        def shim(*args, **kw):
            out = self.real(*args, **kw)
            self.calls.setdefault(key(*args, **kw), (args, kw))
            return out
        setattr(module, attr, shim)

    def restore(self) -> None:
        setattr(self.module, self.attr, self.real)


def k1_key(a, b, c=None, *, block_m=128, block_n=128, block_k=128,
           epilogue="none", **_):
    """(M, K, N, epilogue, dtype, fitted tile, operand layout) of a call."""
    from repro_torch.kernels.matmul import fit
    M, K = a.shape
    N = b.shape[1]
    layout = ("A" if a.stride(1) == 1 else "A^T") + \
        ("B" if b.stride(1) == 1 else "B^T")
    return (M, K, N, epilogue, str(a.dtype).replace("torch.", ""),
            fit(block_m, M), fit(block_n, N), fit(block_k, K), layout)


def k1_tolerance(a, b, c, want, epilogue, alpha, beta):
    """K1 vs its plain version, element by element: the largest
    |got - want| allowed.  Both sum the same f32 products in another
    order, so they differ by rounding noise that grows with sqrt(K) times
    the size of the terms summed, M = |alpha| (|A| @ |B|) + |beta| |C|:
    4 sqrt(K) 2^-24 M (first probe on the card: at most a quarter of this
    at K = 512).  bf16 outputs are also rounded from f32 on both sides, so
    they may land one ulp (<= 2^-7 |want|) apart: two ulps are allowed.
    An error of one product fails the gate."""
    import torch
    K = a.shape[1]
    M = a.float().abs() @ b.float().abs()
    if epilogue == "alpha_beta":
        M = abs(alpha) * M + abs(beta) * c.float().abs()
    tol = 4 * K ** 0.5 * 2.0 ** -24 * M + 1e-6
    if a.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * want.abs()
    return tol


def matmul_bound(M, K, N, dtype: str, epilogue: str):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate (A, B
    and C read once, O written once) and FLOPs (the product and the
    epilogue) over the peak for the input type."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 2 * M * N * K + {"alpha_beta": 3, "relu": 1}.get(epilogue,
                                                              0) * M * N
    nbytes = item * (M * K + K * N + M * N) + (
        4 * M * N if epilogue == "alpha_beta" else 0)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def compare_k1(key, args, kw, timed: bool = True):
    """K1 vs its plain version on one recorded call's inputs; with
    ``timed``, CUDA-event times of both and of one library call."""
    import torch
    from repro_torch.kernels.matmul import matmul, matmul_ref
    M, K, N, ep, dtype, bm, bn, bk, layout = key
    a, b, c = args
    ab = dict(epilogue=ep, alpha=kw.get("alpha", 1.0),
              beta=kw.get("beta", 1.0))
    got = matmul(*args, **kw)
    torch.cuda.synchronize()
    want = matmul_ref(a, b, c, **ab).float()
    diff = (got.float() - want).abs()
    tol = k1_tolerance(a, b, c, want, ep, ab["alpha"], ab["beta"])
    r = {"M": M, "K": K, "N": N, "epilogue": ep, "dtype": dtype,
         "tile": [bm, bn, bk], "layout": layout,
         "finite": bool(torch.isfinite(got).all()),
         "max_abs_err": diff.max().item(),
         "tol_ratio": (diff / tol).max().item()}
    if timed:
        r["ms"] = cuda_ms(lambda: matmul(*args, **kw))
        r["plain_ms"] = cuda_ms(lambda: matmul_ref(a, b, c, **ab))
        if ep == "alpha_beta":
            c_lib = c.to(a.dtype)
            r["library_ms"] = cuda_ms(lambda: torch.addmm(
                c_lib, a, b, beta=ab["beta"], alpha=ab["alpha"]))
        else:
            r["library_ms"] = cuda_ms(lambda: torch.mm(a, b))
        r["bound_ms"], r["bound_by"] = matmul_bound(M, K, N, dtype, ep)
    return r


def mep_scale(log):
    """The scale the MEP settled on, from its sizing log."""
    for line in log:
        m = re.match(r"scale (\d+): accepted", line) or re.match(
            r"fallback to \w+ scale (\d+)", line)
        if m:
            return int(m.group(1))
    fail(f"no MEP scale in {log}")


def phase_campaign(report):
    """A Campaign on the measured h100 platform over the matmul family;
    every FE check and timing of a candidate goes through K1."""
    from repro_torch.core import (Campaign, CaseJob, EvalCache, H100Platform,
                                  HeuristicProposer, PatternStore, ResultsDB,
                                  get_case)
    from repro_torch.kernels.matmul import fit, matmul
    from repro_torch.kernels.suites import polybench

    platform = H100Platform()
    db_path = OUT.parent / "campaign.jsonl"
    OUT.parent.mkdir(exist_ok=True)
    db_path.unlink(missing_ok=True)
    store = PatternStore()
    camp = Campaign(platform, patterns=store, cache=EvalCache(),
                    db=ResultsDB(str(db_path)))
    print(f"campaign on {platform.name} (max_workers {camp.max_workers}, "
          f"D=6 N=3 R=30 k=3, heuristic proposer, shared pattern store):",
          flush=True)
    rec = FirstCalls(polybench, "matmul", k1_key)
    rows, results = [], {}
    matmul.launches = 0                         # the pipeline path's run
    t0 = time.perf_counter()
    try:
        for name in MATMUL_CASES:
            before = matmul.launches
            t = time.perf_counter()
            res = camp.run([CaseJob(get_case(name), HeuristicProposer(
                0, store, platform.name))])[0]
            cands = [c for rl in res.rounds for c in rl.candidates]
            status = {st: sum(c.status == st for c in cands)
                      for st in ("ok", "fe_fail", "build_error",
                                 "run_error")}
            scale = mep_scale(res.mep_log)
            row = {"case": name, "scale": scale,
                   "baseline_ms": res.baseline_time_s * 1e3,
                   "best_ms": res.best_time_s * 1e3,
                   "speedup": res.speedup, "best_variant": res.best_variant,
                   "rounds": len(res.rounds), "candidates": len(cands),
                   "status": status, "aer_repairs": res.aer_records,
                   "launches": matmul.launches - before,
                   "stop_reason": res.stop_reason,
                   "seconds": time.perf_counter() - t}
            rows.append(row)
            results[name] = res
            print(f"  {name:5s} MEP scale {scale}: baseline "
                  f"{row['baseline_ms']:.4f} ms -> best {row['best_ms']:.4f}"
                  f" ms ({row['speedup']:.2f}x, {row['best_variant']}); "
                  f"{len(cands)} candidates FE-checked: {status}; AER "
                  f"repairs {res.aer_records}; K1 launches "
                  f"{row['launches']} ({row['seconds']:.1f} s)", flush=True)
            if row["launches"] == 0:
                fail(f"the {name} campaign never launched K1")
            if status["ok"] == 0:
                fail(f"no {name} candidate reached status ok through K1")
    finally:
        rec.restore()
    launches = matmul.launches
    print(f"campaign: {launches} K1 launches in "
          f"{time.perf_counter() - t0:.1f} s, {len(rec.calls)} distinct "
          f"K1 shapes/tiles", flush=True)
    gemm = results["gemm"]
    S = rows[0]["scale"]
    v = gemm.best_variant
    main_key = (S, S, S, "alpha_beta",
                "bfloat16" if v["compute_dtype"] == "bf16" else "float32",
                fit(v["block_m"], S), fit(v["block_n"], S),
                fit(v["block_k"], S), "AB")
    if main_key not in rec.calls:
        fail(f"gemm's winner {main_key} never reached K1")
    report["campaign"] = {"platform": platform.name, "cases": rows,
                          "launches": launches, "journal": str(
                              db_path.relative_to(ROOT))}
    return launches, rec.calls, main_key


def phase_k1_checks(report, calls, main_key):
    print(f"K1 vs plain at the campaign's {len(calls)} shapes/tiles, on "
          "its inputs (gate: 4 sqrt(K) 2^-24 (|alpha||A||B| + |beta||C|), "
          "plus two ulps in bf16):", flush=True)
    rows = []
    for key, (args, kw) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        r = compare_k1(key, args, kw)
        rows.append(r)
        print(f"  {r['dtype']:8s} {r['M']}x{r['K']}x{r['N']} {r['epilogue']:10s}"
              f" tile {r['tile']} {r['layout']:6s} err {r['max_abs_err']:.3g}"
              f" (of tol {r['tol_ratio']:.2f})  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f}  "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        if not agrees(r):
            fail(f"K1 disagrees with its plain version: {r}")
    args, kw = calls[main_key]
    main = compare_k1(main_key, args, kw)
    print(f"K1 at the main shape (gemm's winner): {main}", flush=True)
    report["k1_checks"] = rows
    report["k1_main_shape"] = main
    return rows, main


def k2_key(q, k, v, **kw):
    return (tuple(q.shape), tuple(k.shape), str(q.dtype))


def phase_integrate(report):
    """optimize(attention_prefill) on h100, then its Integrated Speedup in
    full-width glm4-9b (f32, 40 layers) over 2 x 256 tokens."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (H100Platform, HeuristicProposer, OptConfig,
                                  get_case, integrate, optimize)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.suites import hpc
    from repro_torch.models import get_model

    platform = H100Platform()
    case = get_case("attention_prefill")
    rec = FirstCalls(hpc, "flash_attention", k2_key)
    try:
        flash_attention.launches = 0
        t = time.perf_counter()
        res = optimize(case, platform, HeuristicProposer(0, None,
                                                         platform.name),
                       cfg=OptConfig(d_rounds=2, n_candidates=3))
        opt_launches = flash_attention.launches
        cands = [c for rl in res.rounds for c in rl.candidates]
        n_ok = sum(c.status == "ok" for c in cands)
        print(f"optimize(attention_prefill) on h100: {res.mep_log[0]}; "
              f"{res.baseline_time_s * 1e3:.4f} -> "
              f"{res.best_time_s * 1e3:.4f} ms ({res.speedup:.3f}x, "
              f"{res.best_variant}); {len(cands)} candidates, {n_ok} ok; "
              f"K2 launches {opt_launches} ({time.perf_counter() - t:.1f} s)",
              flush=True)
        if opt_launches == 0 or n_ok == 0:
            fail("optimize(attention_prefill) did not run K2 to an ok "
                 "candidate")

        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config("glm4-9b"),
                                  param_dtype="float32")
        t = time.perf_counter()
        model = get_model(cfg, device="cuda")
        model.init_params(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 256)), device="cuda")
        print(f"glm4-9b float32 ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}) initialised in {time.perf_counter() - t:.1f}"
              f" s", flush=True)

        def make_step():
            return lambda tokens: model.forward(tokens)[0]

        flash_attention.launches = 0
        ir = integrate.integrated_speedup(case, res.best_variant, make_step,
                                          (toks,), platform=platform, r=5,
                                          k=1)
        int_launches = flash_attention.launches
    finally:
        rec.restore()
    print(f"integrated speedup of attention_prefill in glm4-9b (2x256 "
          f"tokens, f32): naive {ir.baseline_time_s * 1e3:.2f} ms -> K2 "
          f"{ir.optimized_time_s * 1e3:.2f} ms per forward = "
          f"{ir.integrated_speedup:.3f}x, fe_ok {ir.fe_ok} (max abs err "
          f"{ir.max_abs_err:.3g}); K2 launches {int_launches}", flush=True)
    need = cfg.n_layers * (1 + 5 + 1)     # warmup, 5 reps, the output call
    if not ir.fe_ok or int_launches < need:
        fail(f"integration: fe_ok {ir.fe_ok}, {int_launches} K2 launches "
             f"({need} expected)")
    checks = []
    for key, (args, kw) in sorted(rec.calls.items()):
        q, k, v = args
        r = compare(q, k, v, kw.get("causal", True))
        checks.append(r)
        print(f"  K2 {r['dtype']} q {key[0]}: max_abs_err "
              f"{r['max_abs_err']:.3g} (of tol {r['tol_ratio']:.2f})",
              flush=True)
        if not agrees(r):
            fail(f"K2 disagrees at the pipeline's shape: {r}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report["integrate"] = {
        "optimize": {"mep_log": res.mep_log, "speedup": res.speedup,
                     "baseline_ms": res.baseline_time_s * 1e3,
                     "best_ms": res.best_time_s * 1e3,
                     "best_variant": res.best_variant,
                     "candidates": len(cands), "ok": n_ok,
                     "launches": opt_launches},
        "model": "glm4-9b float32, 40 layers, 2x256 tokens",
        "baseline_ms": ir.baseline_time_s * 1e3,
        "optimized_ms": ir.optimized_time_s * 1e3,
        "integrated_speedup": ir.integrated_speedup, "fe_ok": ir.fe_ok,
        "max_abs_err": ir.max_abs_err, "launches": int_launches,
        "k2_checks": checks}
    return checks


def fresh_device_time(calls):
    """Profiler device ms of each ``(kernel, args, kwargs)`` call, taken in
    a fresh process (``--device-time``).  Late in this process a trace loses
    kernels (``time_split``); in a new one every trace held them all."""
    import torch
    path = ROOT / "build" / "device_time_inputs.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    try:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--device-time", str(path)],
                             capture_output=True, text=True, timeout=600)
    finally:
        path.unlink(missing_ok=True)
    if res.returncode != 0:
        fail(f"the device-time process failed (exit {res.returncode}):\n"
             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def device_time_child(path: str) -> None:
    """``--device-time PATH``: time_split of each saved call, as JSON."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import matmul
    kernels = {"flash_attention": flash_attention, "matmul": matmul}
    out = []
    for name, args, kw in torch.load(path):
        split = time_split(lambda: kernels[name](*args, **kw),
                           kernels_per_call=1)
        out.append({key: split[key] for key in
                    ("device_ms", "traces", "sentinels_lost")})
    print(json.dumps(out), flush=True)


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
    main_shape = measure_attention(q, k, v, causal=causal, device_time=False)
    if not agrees(main_shape):
        fail(f"kernel disagrees at the serving run's shape: {main_shape}")
    report["main_path_shape"] = main_shape

    k1_launches, k1_calls, main_key = phase_campaign(report)
    k1_rows, k1_main = phase_k1_checks(report, k1_calls, main_key)
    k2_pipeline_checks = phase_integrate(report)
    for r, dev in zip((main_shape, k1_main), fresh_device_time(
            [("flash_attention", (q, k, v), {"causal": causal}),
             ("matmul", *k1_calls[main_key])])):
        r["kernel_device_ms"] = dev["device_ms"]
        r["kernel_trace"] = {key: dev[key]
                             for key in ("traces", "sentinels_lost")}
    print(f"profiler device ms in a fresh process: flash_attention "
          f"{main_shape['kernel_device_ms']:.4f} (CUDA events "
          f"{main_shape['ms']:.4f}), matmul {k1_main['kernel_device_ms']:.4f}"
          f" (CUDA events {k1_main['ms']:.4f})", flush=True)

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in checks + k2_pipeline_checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }, {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/suites/pallas_lib.py:70",
        "launches": k1_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"],
    }]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(f"flash_attention at the serving run's heaviest shape "
          f"(B={main_shape['B']}, S={main_shape['S']}, {main_shape['dtype']}); "
          f"matmul at gemm's winner {list(main_key)}; "
          f"all phases passed in {report['seconds']:.1f} s; details in "
          f"{OUT.relative_to(ROOT)}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--device-time"]:
        device_time_child(sys.argv[2])
    else:
        main()
