#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure (exit 1, no result line):

1. Device: the card's name and power limit; the six CUDA sources (K2
   flash attention, K1 tiled GEMM, K6 WKV6, K7 Mamba-2 SSD, K3 blocked
   sum, K5 grouped GEMM) are built from the checkout (nvcc, sm_90a, one
   nvcc per source, started together) and the build times shown; the
   Triton map kernel K4 is compiled (into build/triton/) by one launch,
   checked against a + b.  A failed build or compile is fatal, and so is a
   spill in K2's tensor-core body at any head_dim, in any of K5's 16
   tensor-core instantiations, in any of K6's 8 or in any of K7's 4
   tensor-core instantiations (registers printed, K3's, K5's, K6's and
   K7's by kernel).
2. Kernel vs plain: the flash-attention kernel against its plain PyTorch
   version at the serving shapes (B 1 and 4; S 8, 64, 96, 256; H 32, KV 2,
   hd 128; bf16 and f32; causal) and at hymba-1.5b's heads (H 25, KV 5, hd
   64) and stablelm-3b's head_dim 80 (bf16, B 2, S 256), each with the body
   it took (``mma``: the tensor cores, which every bf16 row must take;
   ``simt``: the CUDA cores, f32) and CUDA-event times of the kernel, of
   the ``simt`` body on the same bf16 inputs, of the plain version and of
   PyTorch's SDPA (a yardstick only), beside the bound.
3. Serve glm4-9b at full width and depth (40 layers, bf16, random weights
   from a seeded generator) with the kernel installed at the ``attention``
   site: an eager BatchedServer (``aot=False``: every call passes the
   wrappers; 4 slots, max_len 256) answers 8 requests of mixed
   prompt length.  Checks every request's token count, the kernel's launch
   count and its launches by body (none may take ``simt``), and the
   last-token prefill logits through the kernel against the plain version;
   prints the agreement with generate(), tokens/s and peak memory.
4. The kernel against its plain version at every shape the serving run gave
   it, on that run's own inputs (the first call at each (B, S)), each on
   ``mma``.  Then K2 at the main shape (the heaviest of them): the kernel,
   the ``simt`` body and SDPA timed in 5 alternated rounds, the wrapper's
   host µs per call, and a control: the plain version with P cast to bf16
   before PV (as ``attention_chunked`` does) against the plain version,
   which must read above the gate.
5. The paper's pipeline on the card: a ``Campaign`` on the measured ``h100``
   platform with the heuristic proposer over the PolyBench matmul family
   (gemm, 2mm, 3mm, syrk, syr2k), every candidate FE-checked and timed
   through K1 (CUDA events).  Prints each case's MEP scale, baseline → best
   speedup, FE and AER counts and K1 launches; every case must launch K1
   and reach at least one ``ok`` candidate.
6. K1 against its plain version at every (shape, epilogue, dtype, tile,
   layout) the campaign gave it, on the campaign's own inputs (the first
   call at each), each call with the body it ran (``mma``: the tensor
   cores, three TF32 passes in f32; ``simt``: the CUDA cores), its times,
   the bound, the plain version and ``torch.addmm``/``mm`` (a yardstick
   only, ``allow_tf32`` off, which is printed).  Fails if a winner's call
   on a tile in multiples of 16, or the main shape (gemm's winner at gemm's
   MEP scale), took the CUDA cores.  A TF32 control at the main shape: K1
   on operands rounded to TF32, held against the exact operands, must read
   above the gate.  The profiler's device time of K1 there and of K2 at
   phase 4's shape is taken after phase 7 in a fresh process
   (``--device-time``), where traces keep every kernel.
7. ``optimize`` of ``attention_prefill`` on ``h100`` (every variant runs
   K2), then its ``integrated_speedup`` into full-width glm4-9b over 2×256
   tokens: the naive plain-PyTorch attention against the winner's ``cuda``
   build (K2) at the ``attention`` site, in float32, the dtype the case is
   optimized in.  Prints the speedup and ``fe_ok`` (must be true) and K2's
   launches by body (f32: all ``simt``); K2 is held against its plain
   version at every shape this phase gave it.
8. K6 and K7 against their plain versions (outputs and final states) at
   the serving shapes (B 1 and 4; S 8, 64, 128, 256; K6 H 64, K = V 64; K7
   H 50, P 64, N 16), every chunk of the ``rwkv_wkv``/``mamba_ssd``
   variant spaces, bf16 (f32 lw/dt) and f32, with CUDA-event times of the
   kernel and the plain version beside the bound (no PyTorch call computes
   either function: no library yardstick); each K7 row with the body it
   took (every one must take ``mma``, the tensor cores).  Then K7 at B=1
   S=256 chunk 128, bf16 and f32, in 5 alternated rounds: the wrapper, its
   ``mma`` body at both column slices (16 and 32 columns), the ``simt``
   body and the plain version by CUDA events, and the bodies by CUDA-graph
   replay (their device time without the wrapper's host time).
9. Serve rwkv6-7b at full width and depth (32 layers, bf16, 14.0 GiB,
   random weights from a seeded generator) with K6 at ``rwkv_wkv``: a
   BatchedServer (4 slots, exact-length packing) answers 8 requests of 16
   new tokens, prompts of 8–128 tokens and one of 256, through the same
   serving phase as glm4-9b.  Checks every request's token count, K6 at
   every layer of every prefill, and, in float32 on the served weights, the
   last-token prefill logits and final ``wkv`` state through K6 against its
   plain version (RECURRENT_F32_RTOL, with a control on bf16 operands that
   must read above it) and the served requests against generate() over
   their first 8 tokens (a request may differ only from a near-tie on;
   the bf16 comparison, not gated, over 4; both cut for the run's time,
   printed); prints the bf16 figures,
   tokens/s, peak memory and where one decode step and one 2x256 prefill
   spend their time.  K6 is held against its plain version at every
   (B, S) of the run.
10. The same for hymba-1.5b (32 layers, bf16, 3.0 GiB, max_len 272) with
   K7 at ``ssm_chunk`` and K2 at ``attention`` (H 25, KV 5, hd 64): both
   launch counts (K2 and K7 all on ``mma``), the final ``ssm`` state, and
   both kernels held against their plain versions at every (B, S) of the
   run.
11. The paper's Table 4 hotspots: a ``Campaign`` on ``h100`` over
   ``rwkv_wkv`` and ``mamba_ssd`` (every candidate FE-checked and timed
   through K6 or K7), then each winner's ``integrated_speedup`` into
   rwkv6-7b / hymba-1.5b at full width in float32 (each cut to 8 of its
   32 layers, 8.5 and 1.6 GiB, the cuts printed)
   over 2x256 tokens against the naive sequential recurrence; ``fe_ok``
   must be true, and every K7 call of the case and the integration must
   take ``mma`` (launches by body).  K6 and K7 are held against their plain
   versions at every shape the phase gave them.
12. The rest of the suites' kernels: a ``Campaign`` on ``h100`` over the
   four cases whose ``cuda`` build launches a hand-written kernel,
   ``matrixmultiplication`` (K1), ``reduction`` (K3), ``vectoradd`` (K4)
   and ``moe_grouped_gemm`` (K5), as phase 5; each must launch its kernel
   and reach an ``ok`` candidate (K1's and K5's launches counted by body;
   K4's as compiles and cache hits, read when its case ends, which must sum
   to its launches).
13. K1, K3, K4 and K5 against their plain versions at every call phase 12
   gave them, on its inputs (K3 also repeated, on integer-valued inputs and
   one element off a 16-byte boundary, all bitwise equal); each K1 and K5
   call with its body (a tile in multiples of 16 on ``simt`` fails), K1's
   with its times, as phase 6; K3, K4 and K5 timed at their case's winner
   beside the bound, the plain version and the library yardstick
   (``torch.sum``, ``torch.add``, ``torch.bmm``), K3 and K5 in 5 alternated
   rounds with the wrapper's host µs a call (K5 also its ``simt`` body on
   the same inputs); K5 the same at its fixed main shape (E 8 M 512 K 256
   N 512, f32 and bf16, 128^3), where it must take ``mma`` and a TF32
   control must read above the gate.  Every K4 call of ``vectoradd``'s
   ``_add`` must equal the plain version bit for bit; at its winner K4 and
   ``torch.add`` run in 5 alternated rounds with their host µs a call,
   beside the loads in K4's cached kernel's PTX.
14. Tables 1-3 on the card: a ``Campaign`` on ``h100-torch`` (the torch
   build timed with CUDA events, the counterpart of the JAX ``CPUPlatform``
   on its default device) over every PolyBench and APP SDK case and
   ``moe_grouped_gemm``, as phase 5 (adi and gramschm cut to one round of
   R 10, adi's MEP pinned at scale 256, each cut printed); then each
   winner re-timed against its
   baseline in this process, alternating 5 rounds of 30 calls (a winner
   whose build is the baseline's is marked: it can win only timing
   spread); each case's speedup and the suites' means, campaign and
   re-timed, beside the paper's (labelled as the paper's).
15. The paper's search engine on ``h100``: (a) a ``Campaign`` with
   population search (the reference's default ``PopulationConfig``: size 4,
   6 generations, 2 candidates a persona, four expert personae, migration
   on; heuristic proposer, one shared pattern store) over gemm and 2mm
   (K1), rwkv_wkv (K6) and mamba_ssd (K7), at the JAX package's scales:
   each case's generations, evaluations, timing reps paid against fixed R,
   raced kills, migrations, persona stats, seconds and best, beside the
   greedy loop's figures for the case from phases 5 and 11; each case must
   launch its kernel and reach an ``ok`` winner; (b) mamba_ssd's population
   winner reintegrated into hymba-1.5b at full width in f32 over 2 x 256
   tokens (phase 11's inputs, the naive leg re-measured), ``fe_ok`` and
   every K7 launch on ``mma`` required; (c) a ``Campaign`` over gemm with
   ``LLMProposer`` personae (2 generations) behind a scripted transport
   defined here (no model): one endpoint call a wave carrying four
   sections, every parsed candidate FE-checked and timed through K1, and
   one garbage persona reply isolated as a ``ProposalError``.  Every
   kernel launch of the phase must come from the main thread (LLM persona
   threads only wait on the batcher).  Then the greedy and the population
   winner of each case are re-timed in 5 alternated rounds of 30 calls;
   K1, K6 and K7 are held against their plain versions at every shape the
   phase gave them, every K1 call on a tile in multiples of 16 and every
   K7 call on ``mma``.  The phase's wall time is printed on its own line.
16. Online reintegration at full width (bf16, 4 slots, phase 3, 9 and 10's
   requests and weights): (a) glm4-9b served by ``BatchedServer`` on CUDA
   graphs (19 captures: 6 buckets x 1, 2, 4 rows + decode; their seconds
   and memory) against the eager server in 5 alternated rounds (decode
   and prefill tokens/s), its tokens against phase 3's (a request that
   differs must hold its prefill logits, graph against eager, within
   LOGITS_RTOL), one replayed decode step and one replayed 2 x 256
   prefill traced (busy share; the prefill's trace must name K2's
   ``fa_mma_kernel``), ``FixedBatchServer`` on the same requests padded to
   the longest (table 9's baseline), one ``ServeAutotuner.run_once()`` on
   ``h100`` mid-traffic (hot sites, speedups, installs), and a forced
   ``guarded_install`` of ``attention_prefill``'s ``cuda`` build probed by
   a served prefill, which must install, bump one swap epoch and
   re-capture every graph, with in-flight tokens equal to the control;
   (c) the autotuner's thread (``start``/``stop``) beside a second wave,
   with a registry change mid-cycle so that a re-capture waits for the
   device lock: tokens equal, no ``autotune_error``; (b) rwkv6-7b on
   graphs against eager (3 rounds), then mid-traffic ``guarded_install``s
   probed by the served weights' f32 prefill: ``rwkv_wkv``'s ``cuda`` build
   (K6 at chunk 32) must install with the tokens unchanged, the naive
   sequential build must be rolled back for regression with the registry
   restored, and a build off by x 1e3 refused at ``fe_fail``; (d)
   hymba-1.5b on graphs against eager (3 rounds; cut to 8 of its 32
   layers, printed).  K2 and K6 must launch
   on the phase's paths.  The phase's wall time on its own line; the
   journal in chiprun_out/autotune.jsonl.
17. The rest of the decoder-only models through K2 at ``attention``
   (random weights from ``served_model``'s seeded generator; each model
   freed before the next is made): (a) qwen2-moe-a2.7b (moe: 60 experts,
   top 4, a fused shared expert) at full width and depth in bf16, the
   slice's main path: an eager BatchedServer (4 slots, max_len 256)
   answers phase 3's 8 requests, K2 launched at every layer of every
   packed prefill and every launch on ``mma``; the same requests on CUDA
   graphs must give the eager tokens (captures, their seconds, tokens/s
   of both, peak memory); the replayed decode step and 2 x 256 prefill
   traced (the prefill's trace must name ``fa_mma_kernel``); K2 held
   against its plain version at every (B, S) of the run; then the
   last-token prefill logits through K2 against the plain version, in
   float32 at full width and depth (the model converted in place), within
   1e-3 with no token routed to another expert set (the bf16 figures
   printed beside, not gated); (b) command-r-35b at full width and depth
   (bf16, 60.6 GB) and codeqwen1.5-7b, stablelm-3b (head_dim 80),
   chameleon-34b (vlm, qk-norm) and dbrx-132b at full width cut to 4
   layers (each cut printed as ``reduced: n_layers 40→4``), each served
   on CUDA graphs (8 requests; 4 for the cut ones), K2 launched at every
   layer of every prefill capture, all on ``mma``, and held against its
   plain version at every (B, S) of the captures; (c) the int8 KV cache
   on codeqwen1.5-7b (4 layers, float32): 8 teacher-forced decode steps
   against the exact cache, logits within 0.25 and the argmax equal at
   every step, the cache's bytes 130/256 of a bf16 cache's; then its 8
   requests from the int8 cache on CUDA graphs, with the eager server's
   tokens.  The phase's wall time on its own line.
18. whisper-medium (encdec) at full width and depth (24 encoder and 24
   decoder layers, d_model 1024, 1500 frames, bf16, random weights from
   ``served_model``'s seeded generator, frames [4, 1500, 1024] from the
   same seed; nothing cut), served by ``generate()`` with K2 at
   ``attention``: 4 rows, prompts of 8 tokens, 32 new tokens.  K2 takes
   the encoder (non-causal, 1500 x 1500: a ragged key edge), the
   decoder's self-attention (causal, S = T = 8) and cross-attention at
   prefill (S 8, T 1500) and at each decode step (S 1, T 1500): exactly
   24 + 24 + 24 + 24 x 31 = 816 launches, all on ``mma``.  K2 held
   against its plain version at each of those (causal, S, T) on the run's
   inputs; a control, K2 with the causal mask on the encoder's inputs
   against the plain non-causal result, must read above the gate.  K2 at
   the encoder and the decode-cross shapes in 5 alternated rounds (kernel,
   ``simt`` body, plain, SDPA; host µs a call; the bound), the encoder's,
   prefill's and a decode step's ``time_split``, decode tokens/s and peak
   memory.  Then the gate in float32 (converted in place, K2 on
   ``simt``): last-token prefill logits within 1e-3 of the plain
   version's largest and ``generate()``'s tokens equal in 4 of 4 rows;
   the bf16 logits figure printed beside, not gated.  The phase's wall
   time on its own line.
19. Training (every earlier model freed first): (a) stablelm-3b, the
   reference launcher's default arch, trained whole at full width and
   depth (32 layers, d 2560, vocab 50304 padded to 50432, 2,795,932,160
   parameters; bf16 weights, f32 moments, remat; it would not fit 80 GB
   in f32 with AdamW; random weights from ``served_model``'s seed) on
   ``SyntheticLMData`` at a global batch of 8 x S 1024 with ``accum`` 2
   for 8 AdamW steps (lr 3e-4, warmup 2), the plain path at every site:
   each step's loss, grad norm, lr and ms; tokens/s, 6·N·tokens over the
   steady step at the bf16 peak (989 TFLOP/s) and peak memory; the loss
   of a held-out batch (16 x 1024 tokens, every motif of the stream)
   before the first step and after each; the last step's update of four
   leaves (UPDATE_LEAVES) against float64 AdamW from the step's own
   weights, moments, gradients, grad norm and lr.  Fails unless every
   loss and grad norm is finite, the first loss is within 1.5 of ln V,
   the last is below the first, the held-out loss fell, the parameters
   moved and the update agrees with float64 AdamW (moments within
   UPDATE_MOMENT_RTOL, bf16 weights within half an ulp plus
   UPDATE_F32_ROUNDINGS f32 roundings of their operands, and off the
   result rounded to bf16 in at most UPDATE_OFF_SHARE of them).
   Where one step's time goes (``time_split``: three more steps, one
   timed, one traced).  (b) ``core.extraction`` on the twelfth step: the
   top ten hotspots
   (forward, backward and remat's recompute, by einsum spec or call site)
   and every attention hotspot's rank; the top one must be a product and
   an attention hotspot must name the splice point ``'attention'``.  (d)
   A train step with K2 at ``attention`` must raise
   ``NoBackwardKernelError`` before any launch and change nothing.  (c)
   The trained weights served through K2 by an eager BatchedServer (4
   slots, 4 prompts of 32-128 tokens from the training stream, 16 new
   tokens): K2 launched at every layer of every prefill, all on ``mma``
   (bf16, hd 80), held against its plain version at every (B, S) of the
   run, and the last-token prefill logits of a 256-token prompt through K2
   against the plain version within LOGITS_RTOL (phase 3's gate).  (e) The
   fault-tolerant loop on device tensors at the reduced config in f32
   (checkpoint every 4 steps into a temporary directory, a failure
   injected at step 6, 10 steps) ends at the uninterrupted run's
   parameters (within 1e-6); a full-width checkpoint would write ~28 GB
   (weights and moments), so the loop runs reduced.  (f) Two train steps
   of the reduced config in f32 (TF32 off) on the card and on the CPU:
   the first step's gradients, each step's loss, grad norm and lr, and
   the moments within TRAIN_GRAD_TOL, TRAIN_METRIC_RTOL and
   TRAIN_MOMENT_TOL.  The phase's wall time on its own line.
20. The campaign fabric (every earlier model freed, phase 5's winners
   at hand; the phase's processes start side by side): (a) a
   ``Campaign`` on ``h100`` over gemm, 2mm and syrk (K1) at phase 5's D,
   N, R and k with PPI record-only (``ppi=False``, as the reference's chaos
   harness: no winner depends on which concurrent case recorded first) on
   a ``LocalClusterExecutor`` of two worker processes (``python -m
   repro_torch.core.worker_main``; their start-up timed), with a
   file-backed eval cache, pattern store and journal under
   chiprun_out/fabric/.  K1 must launch only in the workers (the
   scheduler's counter stays put), each case must reach an ``ok`` winner,
   no worker launch may fall outside a device-lease hold; each case's
   winner, speedup, FE and AER counts and K1 launches by body and by hold,
   each worker's pid and seconds.  The workers' launches and K1 calls come
   back in the launch log (``REPRO_LAUNCH_LOG``), outside the spec wire;
   K1 is held against its plain version here at every call they reported,
   on ``datagen`` inputs in the reported layout (tiles in multiples of 16
   on ``mma``).  Each winner against phase 5's: equal, or both re-timed in
   5 alternated rounds and within their spread; the fabric's best time
   against phase 5's is printed (readings minutes apart drift beyond a
   CI on this card, so it is not gated; (b)'s alternated one is).  The same campaign again on
   the same cache: no cache miss, the same winners, no K1 launch in FE or
   timing (MEP sizing probes are counted apart: the probe memo is each
   process's own).  (b) Eq. 3 in a worker against eq. 3 here: gemm's
   baseline at its MEP scale timed by a worker's job (no rounds, no
   cache) and by this process under the lease, in 5 alternated rounds;
   their medians must agree within the larger range.  The device-lease
   holds of (a) from the journal: at least two workers, no two holds
   overlapping; the interference control:
   gemm's winner through K1 here, 5 rounds quiet, then 5 while a second
   process launches K1 at 4096³ in a loop, each round read as the median
   one-call rep (as the measured platforms time) and as the mean call of a
   100-call window: the window must read above the quiet rounds' top by
   more than their spread, the rep off the quiet rounds by more than their
   spread (above or below).  (c) A job that crashes its
   worker once: one ``worker_fault`` record, a replacement worker, the
   result equal to (a)'s, and the card's free memory back within
   FABRIC_MEM_TOL of its level before the kill; a job stalled past its
   budget must come back a ``WorkerFault`` of kind ``timeout``.  (d) A
   ``RemoteExecutor`` over two ``spawn`` loopback hosts (aliases fabricA,
   fabricB) runs gemm at two seeds on ``h100``: both aliases' holds on the
   one card's lease, none overlapping, the cache records in both aliases'
   namespaces, ``fleet_events`` printed.  Closing the cluster's workers and
   the fleet's servers must each give the card back at least
   FABRIC_PROCESS_MIN a process.
   The phase's wall time on its own line; the journals under
   chiprun_out/fabric/.
Then the device times at the main shapes (K2, K1 as above, K2 also at
whisper's encoder and decode-cross shapes; K6, K7 at their
serving runs' heaviest prefill; K3, K4, K5 as in phase 13) in a fresh
process (with the wrapper's host µs per call where K2's CUDA-event time
exceeds 1.5x its device time), K7's ``simt`` body, host µs a call and
one-pass controls at its main shape (bf16; and f32: K7 on xh, B and C
rounded to TF32, which must read above the gate), the ``kernels`` JSON
line (K1-K7; K1, K6 and K7's launches include phase 15's, K1's phase
20's workers' (also apart), K2's phases 17, 18 and 19's, with whisper's
two shapes; K1,
K2, K5 and K7 with their launches by body, the main shape's body, the
device time and the TF32, P-in-bf16 or one-pass controls; K2, K3, K4, K5,
K6 and K7 with the host µs a call; K4 with phase 12's compiles and cache hits and its vector loads; K5
at its fixed main shape, its bf16 and winner figures beside) and the
result line.  An f32 GEMM's
bound (K1, K5) counts three TF32 passes on the tensor cores, 165 TFLOP/s.

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
# the card's fastest f32-accurate product: three TF32 passes on the tensor
# cores (495 TFLOP/s dense TF32), as K1 forms it; a bound at the CUDA
# cores' 67 TFLOP/s could read slower than the kernel itself
F32_GEMM_FLOPS = 495e12 / 3
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
KERNEL_SOURCES = ("flash_attention", "matmul", "rwkv_wkv", "ssd_scan",
                  "reduce_sum", "moe_gemm")
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
    path = k2_path(q, k, v)
    want = flash_attention_ref(q, k, v, causal=causal).float()
    diff = (got.float() - want).abs()
    B, S, H, hd = q.shape
    dtype = str(q.dtype).replace("torch.", "")
    rtol, atol = KERNEL_TOL[dtype]
    return {
        "B": B, "S": S, "T": k.shape[1], "H": H, "KV": k.shape[2], "hd": hd,
        "dtype": dtype, "causal": causal, "path": path,
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": diff.max().item(),
        "max_rel_err": (diff.max() / want.abs().max()).item(),
        "tol_ratio": (diff / (atol + rtol * want.abs())).max().item(),
    }


def gate_ratio(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) under K2's gate."""
    rtol, atol = KERNEL_TOL[str(want.dtype).replace("torch.", "")]
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max(
        ).item()


def agrees(r) -> bool:
    return r["finite"] and r["tol_ratio"] <= 1.0


def k2_path(q, k, v) -> str:
    """The body K2 takes on these inputs (``flash_attention.path_for``)."""
    from repro_torch.kernels.flash_attention import path_for
    return path_for(q.dtype, q.shape[3], (q.stride(), k.stride(), v.stride()),
                    (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def require_mma(r, where: str) -> None:
    """A bf16 K2 call at head_dim <= 128 must run on the tensor cores."""
    if r["dtype"] == "bfloat16" and r["hd"] <= 128 and r["path"] != "mma":
        fail(f"K2 ran the {r['path']} body at {where}: {r}")


def p_bf16_control(q, k, v, causal=True) -> float:
    """The plain version with P cast to bf16 before PV, as
    ``attention_chunked`` computes it, against ``flash_attention_ref``, as
    a ratio to K2's gate: it must read above 1, or the gate could not tell
    a one-pass bf16 P from the kernel's hi + lo pair."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models.layers import attention_chunked
    want = flash_attention_ref(q, k, v, causal=causal)
    got = attention_chunked(q, k, v, causal=causal, use_impl=False)
    torch.cuda.synchronize()
    return gate_ratio(got, want)


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host µs per call of ``fn``: ``calls`` launches without a sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def ptxas_kernels(text: str):
    """{kernel: {"registers": n, "spill_bytes": n}} from nvcc's -Xptxas -v
    report (spill stores + loads)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w.$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": 0, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def demangled(name: str) -> str:
    """A kernel's mangled name cut to its name and template arguments, as
    ``gmm_mma_kernel<f32, 32, 1, 0>`` (dtype, slice depth, A and B
    K-major) or ``reduce_kernel<bf16, 1, 16>`` (dtype, 16-byte loads, G)."""
    m = re.search(r"([a-z][a-z_]*_kernel)I(f|13__nv_bfloat16)((?:L[ib]\d+E)*)",
                  name)
    if not m:
        return name
    dtype = "bf16" if "bfloat16" in m.group(2) else "f32"
    return f"{m.group(1)}<" + ", ".join(
        [dtype] + re.findall(r"L[ib](\d+)E", m.group(3))) + ">"


def measure_attention(q, k, v, causal=True):
    """Kernel vs plain version on the same inputs: errors and times, with
    the profiler's device time of the kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     run_body)
    r = compare(q, k, v, causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = attention_bound(r["B"], r["S"], r["T"], r["H"],
                                         r["KV"], r["hd"], r["dtype"], causal)
    split = time_split(lambda: flash_attention(q, k, v, causal=causal),
                       kernels_per_call=1)
    r["kernel_device_ms"] = split["device_ms"]
    r["kernel_trace"] = {key: split[key]
                         for key in ("traces", "sentinels_lost")}
    if r["dtype"] == "bfloat16":     # the CUDA-core body on the same inputs
        r["simt_ms"] = cuda_ms(lambda: run_body(q, k, v, causal=causal,
                                                path="simt"))
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
    # K2's tensor-core body, one instantiation per head_dim: no spills
    fa_mma = {int(re.search(r"ILi(\d+)E", n).group(1)): r for n, r in
              ptxas_kernels(str(build.build_info["flash_attention"]["ptxas"])
                            ).items() if "fa_mma_kernel" in n}
    print("  K2 mma body by head_dim (registers, spill bytes): "
          + ", ".join(f"hd {hd} {r['registers']} {r['spill_bytes']}"
                      for hd, r in sorted(fa_mma.items())), flush=True)
    if sorted(fa_mma) != list(range(16, 129, 16)) or any(
            r["spill_bytes"] for r in fa_mma.values()):
        fail(f"K2's mma body: instantiations or spills {fa_mma}")
    # K5's tensor-core body, 16 instantiations (dtype, slice depth, operand
    # layouts): no spills; K5's and K3's registers by kernel
    k5 = ptxas_kernels(str(build.build_info["moe_gemm"]["ptxas"]))
    k3 = ptxas_kernels(str(build.build_info["reduce_sum"]["ptxas"]))
    k5_mma = {n: r for n, r in k5.items() if "gmm_mma_kernel" in n}
    for label, kern in (("K5", k5), ("K3", k3)):
        print(f"  {label} kernels (registers, spill bytes): " + ", ".join(
            f"{demangled(n)} {r['registers']} {r['spill_bytes']}"
            for n, r in sorted(kern.items())), flush=True)
    if len(k5_mma) != 16 or any(r["spill_bytes"] for r in k5_mma.values()):
        fail(f"K5's mma body: instantiations or spills {k5_mma}")
    # K6's split body, 8 instantiations (dtype, head size): no spills
    k6 = ptxas_kernels(str(build.build_info["rwkv_wkv"]["ptxas"]))
    print("  K6 kernels (registers, spill bytes): " + ", ".join(
        f"{demangled(n)} {r['registers']} {r['spill_bytes']}"
        for n, r in sorted(k6.items())), flush=True)
    if len(k6) != 8 or any(r["spill_bytes"] for r in k6.values()):
        fail(f"K6's body: instantiations or spills {k6}")
    # K7's tensor-core body, 4 instantiations (dtype, column slice): no
    # spills; its simt body's registers beside
    k7 = ptxas_kernels(str(build.build_info["ssd_scan"]["ptxas"]))
    k7_mma = {n: r for n, r in k7.items() if "ssd_mma_kernel" in n}
    print("  K7 kernels (registers, spill bytes): " + ", ".join(
        f"{demangled(n)} {r['registers']} {r['spill_bytes']}"
        for n, r in sorted(k7.items())), flush=True)
    if len(k7_mma) != 4 or any(r["spill_bytes"] for r in k7_mma.values()):
        fail(f"K7's mma body: instantiations or spills {k7_mma}")
    # K4 is Triton: compiled at its first launch, which is checked here
    from repro_torch.kernels.elementwise import elementwise
    from repro_torch.kernels.suites.appsdk import _add
    t0 = time.perf_counter()
    a, b = (torch.randn(10000, device="cuda") for _ in range(2))
    try:
        got = elementwise(_add, a, b, block=4096)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"compiling the Triton map kernel failed: {e}")
    if not torch.equal(got, a + b):
        fail("the Triton map kernel's first launch disagrees with a + b")
    triton_s = time.perf_counter() - t0
    print(f"  elementwise.py (Triton): compile and first launch "
          f"{triton_s:.2f} s", flush=True)
    report["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__,
                        "triton_compile_s": triton_s,
                        "build_s": {n: build.build_info[n]["seconds"]
                                    for n in KERNEL_SOURCES},
                        "k2_mma_ptxas": fa_mma,
                        "k5_ptxas": {demangled(n): r for n, r in k5.items()},
                        "k3_ptxas": {demangled(n): r for n, r in k3.items()},
                        "k6_ptxas": {demangled(n): r for n, r in k6.items()},
                        "k7_ptxas": {demangled(n): r for n, r in k7.items()},
                        "ptxas": {n: [line.strip() for line in str(
                            build.build_info[n]["ptxas"]).splitlines()
                            if "registers" in line or "spill" in line]
                            for n in KERNEL_SOURCES}}
    return name, smi


def print_k2(r):
    simt = f"  simt {r['simt_ms']:.4f}" if "simt_ms" in r else ""
    print(f"  {r['dtype']:8s} B={r['B']} S={r['S']:3d} H {r['H']} KV "
          f"{r['KV']} hd {r['hd']:3d} {r['path']:4s} max_abs_err "
          f"{r['max_abs_err']:.3g} (of tol {r['tol_ratio']:.2f})  kernel "
          f"{r['ms']:.4f} ms (device {r['kernel_device_ms']:.4f}){simt}  "
          f"plain {r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def phase_kernel(report):
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    print("kernel vs plain (flash_attention, causal; body: mma = tensor "
          "cores, simt = CUDA cores, timed on the same bf16 inputs):",
          flush=True)
    shapes = [(dtype, B, S, 32, 2, 128) for dtype in (torch.bfloat16,
                                                     torch.float32)
              for B in (1, 4) for S in (8, 64, 96, 256)]
    shapes += [(torch.bfloat16, 2, 256, 25, 5, 64),    # hymba-1.5b's heads
               (torch.bfloat16, 2, 256, 32, 32, 80)]   # stablelm-3b's
    for dtype, B, S, H, KV, hd in shapes:
        q = torch.randn(B, S, H, hd, device="cuda", generator=g)
        k = torch.randn(B, S, KV, hd, device="cuda", generator=g)
        v = torch.randn(B, S, KV, hd, device="cuda", generator=g)
        r = measure_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        rows.append(r)
        print_k2(r)
        if not agrees(r):
            fail(f"kernel disagrees with its plain version: {r}")
        require_mma(r, "phase 2")
    report["kernel_vs_plain"] = rows


# --------------------------------------------------------------------------
# the MEP pipeline on the card (phases 5-7)
# --------------------------------------------------------------------------
class FirstCalls:
    """Passes every call on to ``fn`` (a kernel wrapper, whose launch
    counter counts as before) and keeps the arguments of the first call at
    each ``key(*args, **kw)`` that launched (a call the wrapper refuses,
    such as a tile that automatic error repair then shrinks, is not kept);
    the key defaults to the first argument's (B, S).  It serves as a site
    impl as it stands; ``at(module, attr, key)`` puts one where a module
    looks the wrapper up, until ``restore``."""

    def __init__(self, fn, key=lambda *args, **kw: tuple(args[0].shape[:2])):
        self.fn, self.key, self.calls = fn, key, {}

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.setdefault(self.key(*args, **kw), (args, kw))
        return out

    @classmethod
    def at(cls, module, attr, key):
        rec = cls(getattr(module, attr), key)
        setattr(module, attr, rec)
        rec.restore = lambda: setattr(module, attr, rec.fn)
        return rec


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


def gemm_peak(dtype: str) -> float:
    """FLOP/s of a GEMM's least time: bf16 at the tensor cores' peak, f32
    at three TF32 passes' (F32_GEMM_FLOPS)."""
    return F32_GEMM_FLOPS if dtype == "float32" else PEAK_FLOPS[dtype]


def matmul_bound(M, K, N, dtype: str, epilogue: str):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate (A, B
    and C read once, O written once) and FLOPs (the product and the
    epilogue) over ``gemm_peak``."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 2 * M * N * K + {"alpha_beta": 3, "relu": 1}.get(epilogue,
                                                              0) * M * N
    nbytes = item * (M * K + K * N + M * N) + (
        4 * M * N if epilogue == "alpha_beta" else 0)
    t_ops, t_bytes = flops / gemm_peak(dtype), nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def launch_body(kernel, *args, **kw):
    """``kernel(*args, **kw)`` (K1 or K5) and the body (path) its launch
    took."""
    import torch
    before = dict(kernel.launches_by_path)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    (path,) = [p for p, n in kernel.launches_by_path.items()
               if n != before[p]]
    return got, path


def compare_k1(key, args, kw, timed: bool = True):
    """K1 vs its plain version on one recorded call's inputs, and the body
    (path) it took; with ``timed``, CUDA-event times of both and of one
    library call."""
    import torch
    from repro_torch.kernels.matmul import matmul, matmul_ref
    M, K, N, ep, dtype, bm, bn, bk, layout = key
    a, b, c = (*args, None)[:3]
    ab = dict(epilogue=ep, alpha=kw.get("alpha", 1.0),
              beta=kw.get("beta", 1.0))
    got, path = launch_body(matmul, *args, **kw)
    want = matmul_ref(a, b, c, **ab).float()
    diff = (got.float() - want).abs()
    tol = k1_tolerance(a, b, c, want, ep, ab["alpha"], ab["beta"])
    r = {"M": M, "K": K, "N": N, "epilogue": ep, "dtype": dtype,
         "tile": [bm, bn, bk], "layout": layout, "path": path,
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


def run_case(camp, store, platform, name, proposer=None, cfg=None,
             scale=None):
    """One case through ``camp`` with ``proposer`` (the heuristic one by
    default) and ``cfg`` (the default ``OptConfig``: D 6, N 3, R 30, k 3),
    its MEP auto-sized or pinned at ``scale``: the result and its row (MEP
    scale, baseline -> best, candidates by status, AER repairs, rounds,
    timing reps paid and what fixed R would have paid, seconds)."""
    from repro_torch.core import (CaseJob, HeuristicProposer, OptConfig,
                                  build_mep, get_case)
    t = time.perf_counter()
    case = get_case(name)
    mep = build_mep(case, platform, scale=scale) if scale else None
    res = camp.run([CaseJob(case, proposer or HeuristicProposer(
        0, store, platform.name), cfg=cfg or OptConfig(), mep=mep)])[0]
    cands = [c for rl in res.rounds for c in rl.candidates]
    status = {st: sum(c.status == st for c in cands)
              for st in ("ok", "fe_fail", "build_error", "run_error")}
    ci = [c.ci_half_width_s for c in cands if c.status == "ok"
          and c.variant == res.best_variant and not c.cached]
    return res, {"case": name, "suite": get_case(name).suite,
                 "scale": mep_scale(res.mep_log),
                 "baseline_ms": res.baseline_time_s * 1e3,
                 "best_ms": res.best_time_s * 1e3, "speedup": res.speedup,
                 "best_ci_ms": ci[0] * 1e3 if ci else 0.0,
                 "best_variant": res.best_variant,
                 "candidates": len(cands), "status": status,
                 "aer_repairs": res.aer_records,
                 "rounds": len(res.rounds),
                 "timing_reps": res.timing_reps,
                 "timing_reps_fixed": res.timing_reps_fixed,
                 "raced_out": res.raced_out,
                 "seconds": time.perf_counter() - t}


def phase_campaign(report):
    """A Campaign on the measured h100 platform over the matmul family;
    every FE check and timing of a candidate goes through K1."""
    from repro_torch.core import (Campaign, EvalCache, H100Platform,
                                  PatternStore, ResultsDB)
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
    rec = FirstCalls.at(polybench, "matmul", k1_key)
    rows, results = [], {}
    matmul.launches = 0                         # the pipeline path's run
    matmul.launches_by_path = dict.fromkeys(matmul.launches_by_path, 0)
    t0 = time.perf_counter()
    try:
        for name in MATMUL_CASES:
            before = matmul.launches
            res, row = run_case(camp, store, platform, name)
            row.update(launches=matmul.launches - before,
                       stop_reason=res.stop_reason)
            rows.append(row)
            results[name] = res
            print(f"  {name:5s} MEP scale {row['scale']}: baseline "
                  f"{row['baseline_ms']:.4f} ms -> best {row['best_ms']:.4f}"
                  f" ms ({row['speedup']:.2f}x, {row['best_variant']}); "
                  f"{row['candidates']} candidates FE-checked: "
                  f"{row['status']}; AER repairs {res.aer_records}; K1 "
                  f"launches {row['launches']} ({row['seconds']:.1f} s)",
                  flush=True)
            if row["launches"] == 0:
                fail(f"the {name} campaign never launched K1")
            if row["status"]["ok"] == 0:
                fail(f"no {name} candidate reached status ok through K1")
    finally:
        rec.restore()
    launches = {"total": matmul.launches, **matmul.launches_by_path}
    print(f"campaign: {launches['total']} K1 launches ({launches['mma']} "
          f"on the tensor cores, {launches['simt']} on the CUDA cores) in "
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


def print_k1(r):
    print(f"  {r['dtype']:8s} {r['M']}x{r['K']}x{r['N']} {r['epilogue']:10s}"
          f" tile {r['tile']} {r['layout']:6s} {r['path']:4s} err "
          f"{r['max_abs_err']:.3g} (of tol {r['tol_ratio']:.2f})  kernel "
          f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  library "
          f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
          f"({r['bound_by']})", flush=True)


def winner_k1_keys(calls, variant):
    """The recorded K1 calls a matmul winner's tile made: keys whose fitted
    tile and dtype are the variant's."""
    from repro_torch.kernels.matmul import fit
    dtype = "bfloat16" if variant.get("compute_dtype") == "bf16" \
        else "float32"
    return [key for key in calls if key[4] == dtype and tuple(key[5:8]) == (
        fit(variant.get("block_m", 128), key[0]),
        fit(variant.get("block_n", 128), key[2]),
        fit(variant.get("block_k", 128), key[1]))]


def require_tensor_cores(rows, calls, winners):
    """Fails unless every call of each winner with a tile in multiples of
    16 (128^3 among them) ran on the tensor cores."""
    path = {tuple(r["key"]): r["path"] for r in rows}
    for case, variant in winners.items():
        for key in winner_k1_keys(calls, variant):
            if all(t % 16 == 0 for t in key[5:8]) and path[key] != "mma":
                fail(f"{case}'s winner {variant} ran K1 on the {path[key]} "
                     f"path at {key}")


def tf32(x):
    """x rounded to TF32 to nearest, ties away from zero (cvt.rna)."""
    import torch
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_control(args, kw):
    """K1 on its operands rounded to TF32 (the error of one TF32 pass)
    against the plain version on the exact operands: the gate must read
    above 1, or it could not see what three passes avoid."""
    from repro_torch.kernels.matmul import matmul, matmul_ref
    a, b, c = args
    ab = dict(epilogue=kw["epilogue"], alpha=kw.get("alpha", 1.0),
              beta=kw.get("beta", 1.0))
    want = matmul_ref(a, b, c, **ab)
    got = matmul(tf32(a), tf32(b), c, **kw)
    tol = k1_tolerance(a, b, c, want, ab["epilogue"], ab["alpha"],
                       ab["beta"])
    return ((got - want).abs() / tol).max().item()


def phase_k1_checks(report, calls, main_key):
    import torch
    print(f"K1 vs plain at the campaign's {len(calls)} shapes/tiles, on "
          "its inputs (gate: 4 sqrt(K) 2^-24 (|alpha||A||B| + |beta||C|), "
          "plus two ulps in bf16; path: mma = tensor cores, simt = CUDA "
          "cores; library: torch.addmm/mm with allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}):", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: addmm would not "
             "be the f32 yardstick")
    rows = []
    for key, (args, kw) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        r = compare_k1(key, args, kw)
        r["key"] = list(key)
        rows.append(r)
        print_k1(r)
        if not agrees(r):
            fail(f"K1 disagrees with its plain version: {r}")
    require_tensor_cores(rows, calls, {c["case"]: c["best_variant"]
                                       for c in report["campaign"]["cases"]})
    args, kw = calls[main_key]
    main = compare_k1(main_key, args, kw)
    print(f"K1 at the main shape (gemm's winner): {main}", flush=True)
    if main["path"] != "mma":
        fail(f"the main shape ran K1 on the {main['path']} path")
    main["tf32_control_tol_ratio"] = tf32_control(args, kw)
    print(f"TF32 control at the main shape (K1 on operands rounded to "
          f"TF32, against the exact operands): "
          f"{main['tf32_control_tol_ratio']:.2f} of the gate (must read "
          f"above 1)", flush=True)
    if main["tf32_control_tol_ratio"] <= 1.0:
        fail("the gate does not see one TF32 pass's error at the main shape")
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
    rec = FirstCalls.at(hpc, "flash_attention", k2_key)
    by_path = flash_attention.launches_by_path
    try:
        flash_attention.launches = 0
        by_path.update(mma=0, simt=0)
        t = time.perf_counter()
        res = optimize(case, platform, HeuristicProposer(0, None,
                                                         platform.name),
                       cfg=OptConfig(d_rounds=2, n_candidates=3))
        opt_launches = flash_attention.launches
        opt_by_path = dict(by_path)
        cands = [c for rl in res.rounds for c in rl.candidates]
        n_ok = sum(c.status == "ok" for c in cands)
        print(f"optimize(attention_prefill) on h100: {res.mep_log[0]}; "
              f"{res.baseline_time_s * 1e3:.4f} -> "
              f"{res.best_time_s * 1e3:.4f} ms ({res.speedup:.3f}x, "
              f"{res.best_variant}); {len(cands)} candidates, {n_ok} ok; "
              f"K2 launches {opt_launches} {opt_by_path} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
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
        by_path.update(mma=0, simt=0)
        ir = integrate.integrated_speedup(case, res.best_variant, make_step,
                                          (toks,), platform=platform, r=5,
                                          k=1)
        int_launches = flash_attention.launches
        int_by_path = dict(by_path)
    finally:
        rec.restore()
    print(f"integrated speedup of attention_prefill in glm4-9b (2x256 "
          f"tokens, f32): naive {ir.baseline_time_s * 1e3:.2f} ms -> K2 "
          f"{ir.optimized_time_s * 1e3:.2f} ms per forward = "
          f"{ir.integrated_speedup:.3f}x, fe_ok {ir.fe_ok} (max abs err "
          f"{ir.max_abs_err:.3g}); K2 launches {int_launches} {int_by_path}",
          flush=True)
    need = cfg.n_layers * (1 + 5 + 1)     # warmup, 5 reps, the output call
    if not ir.fe_ok or int_launches < need:
        fail(f"integration: fe_ok {ir.fe_ok}, {int_launches} K2 launches "
             f"({need} expected)")
    if opt_by_path["mma"] or int_by_path["mma"]:   # f32: the CUDA cores
        fail(f"phase 7's f32 K2 calls took the tensor cores: {opt_by_path},"
             f" {int_by_path}")
    checks = []
    for key, (args, kw) in sorted(rec.calls.items()):
        q, k, v = args
        r = compare(q, k, v, kw.get("causal", True))
        checks.append(r)
        print(f"  K2 {r['dtype']} q {key[0]} ({r['path']}): max_abs_err "
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
                     "launches": opt_launches,
                     "launches_by_path": opt_by_path},
        "model": "glm4-9b float32, 40 layers, 2x256 tokens",
        "baseline_ms": ir.baseline_time_s * 1e3,
        "optimized_ms": ir.optimized_time_s * 1e3,
        "integrated_speedup": ir.integrated_speedup, "fe_ok": ir.fe_ok,
        "max_abs_err": ir.max_abs_err, "launches": int_launches,
        "launches_by_path": int_by_path,
        "k2_checks": checks}
    return checks


# --------------------------------------------------------------------------
# the recurrent families (phases 8-11): K6 (WKV6) and K7 (Mamba-2 SSD)
# --------------------------------------------------------------------------
# K6/K7 vs their plain versions, element by element: |got - want| <= atol *
# max|want| + rtol * |want|, as (rtol, atol).  Both compute in f32 and sum
# the same terms in another order (K7's plain version chunks as the kernel
# does; K6's runs the recurrence step by step): f32 noise relative to the
# output's largest magnitude (first probe on the card: <= 4e-6 of it).  In
# bf16 the f32 results are rounded once on both sides, at most one ulp
# (<= 2^-7 |want|) apart; two are allowed.  Final states are f32 in both
# dtypes and take the f32 gate.
RECURRENT_TOL = {"float32": (1e-4, 4e-5), "bfloat16": (2.0 ** -6, 4e-5)}
RECURRENT_CHUNKS = {"wkv": (16, 32, 64, 128),       # the cases' variants
                    "ssd": (32, 64, 128, 256)}
MODEL_CHUNK = 128                 # rwkv6-7b's and hymba-1.5b's ssm.chunk
TABLE4_CASES = {"rwkv_wkv": ("wkv", "rwkv6-7b"),
                "mamba_ssd": ("ssd", "hymba-1.5b")}
# Table 4's application cut in depth at full width: rwkv6-7b's naive
# sequential recurrence took 3.8 s a forward at 32 layers on the H100, 26 s
# of the phase over its 7 forwards, and its layers are alike, so the
# Integrated Speedup is close to a per-layer ratio; hymba-1.5b's likewise,
# for the run's time cap
TABLE4_CUTS = {"rwkv6-7b": 8, "hymba-1.5b": 8}
# phase 16's hymba-1.5b leg (graphs against eager, a replayed decode step)
# cut in depth at full width, for the run's time cap
ONLINE_CUTS = {"hymba-1.5b": 8}


def kernel_pair(name):
    """(kernel wrapper, plain version) of K2 (``flash_attention``), K6
    (``wkv``) or K7 (``ssd``)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.rwkv_wkv import wkv, wkv_plain
    from repro_torch.kernels.ssd_scan import ssd, ssd_plain
    return {"flash_attention": (flash_attention, flash_attention_ref),
            "wkv": (wkv, wkv_plain), "ssd": (ssd, ssd_plain)}[name]


def recurrent_gate(got, want, dtype: str):
    """(max abs err, tol_ratio) of ``got`` against ``want`` under
    RECURRENT_TOL: the kernel agrees when the ratio is at most 1."""
    rtol, atol = RECURRENT_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    w = want.float().abs()
    ratio = diff / (atol * w.max() + rtol * w + 1e-30)
    return diff.max().item(), ratio.max().item()


def recurrent_bound(kind, args):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    (inputs read once, output and final state written once) and the least
    f32 operations the function needs, those of its sequential form, over
    67 TFLOP/s (K6 computes in f32 on the CUDA cores in either dtype; K7's
    tensor-core body keeps f32 accuracy, and at the served and case shapes
    its bytes bound it at either rate).  Per (token, head): K6 r·S (2KV), the bonus (3K + 2V) and the
    state update (3KV); K7 u = dt·x (P), the state update exp(la)·S + u⊗B
    (3PN) and C·S (2PN).  The chunked form K7 runs does more (the causal
    C·Bᵀ and intra product grow with the chunk): that is the kernel's
    cost, not the function's, and the bound does not depend on the chunk."""
    item = args[0].element_size()
    if kind == "wkv":
        r, k, v, lw, u = args
        B, S, H, K = r.shape
        V = v.shape[3]
        nbytes = item * (2 * B * S * H * K + 2 * B * S * H * V + H * K) \
            + 4 * B * S * H * K + 4 * B * H * K * V
        flops = B * S * H * (5 * K * V + 3 * K + 2 * V)
    else:
        xh, dt, a_log, B_t, C_t = args
        B, S, H, P = xh.shape
        N = B_t.shape[2]
        nbytes = item * (2 * B * S * H * P + 2 * B * S * N) \
            + 4 * (B * S * H + H) + 4 * B * H * P * N
        flops = B * S * H * (5 * P * N + P)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def compare_recurrent(kind, args, chunk, timed: bool = False):
    """K6/K7 vs its plain version on the same inputs: output and final
    state; with ``timed``, CUDA-event times of both beside the bound."""
    import torch
    kernel, plain = kernel_pair(kind)
    out, state = kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    want, want_state = plain(*args, chunk=chunk)
    dtype = str(args[0].dtype).replace("torch.", "")
    err, ratio = recurrent_gate(out, want, dtype)
    s_err, s_ratio = recurrent_gate(state, want_state, "float32")
    r = {"kernel": kind, "shape": list(args[0].shape), "dtype": dtype,
         "chunk": chunk, **({"path": k7_path(args, chunk)} if kind == "ssd"
                            else {}),
         "finite": bool(torch.isfinite(out).all()
                        and torch.isfinite(state).all()),
         "max_abs_err": err, "state_max_abs_err": s_err,
         "tol_ratio": max(ratio, s_ratio)}
    if timed:
        r["ms"] = cuda_ms(lambda: kernel(*args, chunk=chunk))
        r["plain_ms"] = cuda_ms(lambda: plain(*args, chunk=chunk), reps=3,
                                warmup=1)
        r["bound_ms"], r["bound_by"] = recurrent_bound(kind, args)
        r["library_ms"] = None     # no single PyTorch call computes it
    return r


def k7_path(args, chunk) -> str:
    """The body K7 takes on these inputs (``ssd_scan.path_for``)."""
    from repro_torch.kernels.ssd_scan import path_for
    xh, B_t = args[0], args[3]
    return path_for(xh.dtype, min(chunk, xh.shape[1]), B_t.shape[2],
                    xh.stride()[:3], xh.data_ptr())


def require_k7_mma(rows, where: str) -> None:
    """Every served and case call of K7 takes the tensor cores."""
    bad = [r for r in rows if r.get("path") != "mma"]
    if bad:
        fail(f"K7 ran the simt body at {where}: {bad}")


def recurrent_inputs(kind, B, S, dtype, g):
    """Inputs of K6 at rwkv6-7b's shapes (H 64, K = V = 64) or of K7 at
    hymba-1.5b's (H 50, P 64, N 16; B_t and C_t two halves of one
    projection, as the model passes them), in ``dtype`` with f32 lw/dt."""
    import torch
    if kind == "wkv":
        r, k, v = (0.5 * torch.randn(B, S, 64, 64, device="cuda",
                                     generator=g) for _ in range(3))
        lw = -torch.rand(B, S, 64, 64, device="cuda", generator=g) * 3 \
            - 0.01
        u = 0.5 * torch.randn(64, 64, device="cuda", generator=g)
        return (r.to(dtype), k.to(dtype), v.to(dtype), lw, u.to(dtype))
    xh = torch.randn(B, S, 50, 64, device="cuda", generator=g)
    dt = torch.rand(B, S, 50, device="cuda", generator=g) * 0.1 + 0.001
    a_log = torch.rand(50, device="cuda", generator=g) * 2 - 1
    bc = torch.randn(B, S, 32, device="cuda", generator=g).to(dtype)
    B_t, C_t = torch.chunk(bc, 2, dim=-1)
    return (xh.to(dtype), dt, a_log, B_t, C_t)


def phase_recurrent_kernels(report):
    """Phase 8: K6 and K7 against their plain versions at the serving
    shapes, every chunk of the cases' variant spaces, f32 and bf16."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    print("kernel vs plain (K6 wkv: H 64, K = V 64; K7 ssd: H 50, P 64, "
          "N 16), every chunk of the case's variant space; times at chunk "
          f"{MODEL_CHUNK}, the models' (gate: {RECURRENT_TOL}):", flush=True)
    for kind in ("wkv", "ssd"):
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 4):
                for S in (8, 64, 128, 256):
                    args = recurrent_inputs(kind, B, S, dtype, g)
                    group = [compare_recurrent(kind, args, c,
                                               timed=c == MODEL_CHUNK)
                             for c in RECURRENT_CHUNKS[kind]]
                    rows += group
                    bad = [r for r in group if not agrees(r)]
                    if bad:
                        fail(f"{kind} disagrees with its plain version: "
                             f"{bad}")
                    t = next(r for r in group if "ms" in r)
                    body = (" " + "/".join(r["path"] for r in group)
                            if kind == "ssd" else "")
                    print(f"  {kind} {t['dtype']:8s} B={B} S={S:3d}{body}  "
                          f"max_abs_err {max(r['max_abs_err'] for r in group):.3g}"
                          f" state {max(r['state_max_abs_err'] for r in group):.3g}"
                          f" (of tol {max(r['tol_ratio'] for r in group):.2f})"
                          f"  kernel {t['ms']:.4f} ms  plain "
                          f"{t['plain_ms']:.4f} ms  library none  bound "
                          f"{t['bound_ms']:.4f} ms ({t['bound_by']})",
                          flush=True)
                    if kind == "ssd":
                        require_k7_mma(group, "phase 8")
    report["recurrent_kernel_vs_plain"] = rows
    report["ssd_bodies"] = ssd_body_times(g)


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA
    graph, its replay timed by CUDA events, so a short kernel is not hidden
    behind its wrapper's host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ssd_body_times(g):
    """K7 at hymba-1.5b's served shape (B=1 S=256, H 50, P 64, N 16),
    bf16 and f32, chunk 128, in 5 alternated rounds: the wrapper, its
    ``mma`` body at each column slice (16 and 32 columns, ``geometry``
    takes one), the ``simt`` body and the plain version, by CUDA events;
    then the bodies' device ms by CUDA-graph replay, also alternated."""
    import torch
    from repro_torch.kernels import ssd_scan as k7
    print("K7 at B=1 S=256 chunk 128 (medians of 5 alternated rounds, ms; "
          "CUDA events, then CUDA-graph replay):", flush=True)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        args = recurrent_inputs("ssd", 1, 256, dtype, g)
        bodies = {f"mma{w}_ms": (lambda w=w: k7.run_body(
            *args, chunk=MODEL_CHUNK, path="mma", width=w)) for w in (16, 32)}
        bodies["simt_ms"] = lambda: k7.run_body(*args, chunk=MODEL_CHUNK,
                                                path="simt")
        r = alternated({"ms": lambda: k7.ssd(*args, chunk=MODEL_CHUNK),
                        **bodies,
                        "plain_ms": lambda: k7.ssd_plain(
                            *args, chunk=MODEL_CHUNK)},
                       reps={"plain_ms": 3})
        graphs = {n: [] for n in bodies}
        for _ in range(5):
            for n, fn in bodies.items():
                graphs[n].append(graph_ms(fn))
        r.update({f"graph_{n}": float(np.median(v))
                  for n, v in graphs.items()},
                 graph_rounds=graphs, dtype=str(dtype)[6:],
                 width=k7.geometry(1, 50, 64)[0],
                 path=k7_path(args, MODEL_CHUNK))
        out.append(r)
        print(f"  {r['dtype']:8s} ({r['path']}, slices of {r['width']}): "
              f"wrapper {r['ms']:.4f}, mma 16 {r['mma16_ms']:.4f}, mma 32 "
              f"{r['mma32_ms']:.4f}, simt {r['simt_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}; graph replay: mma 16 "
              f"{r['graph_mma16_ms']:.4f}, mma 32 {r['graph_mma32_ms']:.4f},"
              f" simt {r['graph_simt_ms']:.4f}", flush=True)
    return out


# the served models: site → the kernel installed there
SERVE_SITES = {"glm4-9b": {"attention": "flash_attention"},
               "rwkv6-7b": {"rwkv_wkv": "wkv"},
               "hymba-1.5b": {"ssm_chunk": "ssd",
                              "attention": "flash_attention"}}
# the recurrent state a prefill hands decode, by family
STATE_KEY = {"ssm": "wkv", "hybrid": "ssm"}
RECURRENT_SITES = ("rwkv_wkv", "ssm_chunk")


def site_impl(site, fn):
    """``fn`` as the impl at ``site``.  K6, K7 and their plain versions
    return (out, state) on every call; at a recurrent site they go through
    ``models.ssm.stateful_site``, which takes the keyword with which the
    model asks for the state.  None (no impl) stays None."""
    from repro_torch.models.ssm import stateful_site
    return (stateful_site(fn) if fn is not None and site in RECURRENT_SITES
            else fn)
# the operands the model passes K6/K7 in its own dtype (lw, dt and a_log
# come in f32)
MODEL_DTYPE_ARGS = {"wkv": (0, 1, 2, 4), "ssd": (0, 3, 4)}
# the recurrent models' prefill through their kernels vs the plain versions
# in float32 on the served weights, logits and final state each relative
# to its largest magnitude: f32 summation noise through 32 layers (seen on
# the H100: 3.9e-5 to 4.3e-5 rwkv6-7b, 8.5e-6 to 1.3e-5 hymba-1.5b).  The
# control, the same kernels on bf16 operands, must read above it (seen:
# 0.096-0.097 rwkv6-7b, 0.013-0.032 hymba-1.5b).  A request served in f32
# may leave generate() only at a near-tie: where generate()'s token and the
# served one lie within this share of the largest logit (seen: 9.7e-6).
RECURRENT_F32_RTOL = 1e-3


def rel_err(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def prefill_with(model, tokens, impls):
    """(last-token logits over the true vocabulary, cache) of a prefill of
    ``tokens`` [1, S] with ``impls`` (site → impl; None: no impl, the
    model's chunked plain path) put over the installed ones for the call."""
    import contextlib
    import torch
    from repro_torch.kernels import ops
    with contextlib.ExitStack() as scope, torch.no_grad():
        for site, fn in impls.items():
            scope.enter_context(ops.use_impl(site, site_impl(site, fn)))
        logits, cache = model.prefill(tokens)
    # the padded vocabulary's logits are -1e30 on every path
    return logits[0, -1, :model.cfg.vocab_size], cache


def bf16_operands(name):
    """The f32 gate's control: K6 or K7 on bf16 copies of the operands the
    model passes in its own dtype, the output handed back in f32."""
    kernel = kernel_pair(name)[0]

    def call(*args, **kw):
        out, state = kernel(*(a.bfloat16() if i in MODEL_DTYPE_ARGS[name]
                              else a for i, a in enumerate(args)), **kw)
        return out.float(), state
    return call


def check_recurrent_f32(model, prompts, probe, kernels, max_len, max_new):
    """The recurrent model on the served weights in float32: the prefill of
    ``prompts[probe]`` through the kernels against their plain versions
    (logits and final state within RECURRENT_F32_RTOL) and against the
    control; then the served path, prefill through the kernels and decode
    from their state, against generate() token for token, where a request
    may differ only from a near-tie on.  Returns the readings."""
    import dataclasses
    import torch
    from repro_torch.models import get_model
    from repro_torch.serve import BatchedServer, generate

    cfg = model.cfg
    arch, key = cfg.name, STATE_KEY[cfg.family]
    m32 = get_model(dataclasses.replace(cfg, param_dtype="float32"),
                    device="cuda")
    m32.load_state_dict(model.state_dict())
    p0 = torch.as_tensor(prompts[probe], dtype=torch.long,
                         device="cuda")[None]
    lk, ck = prefill_with(m32, p0, {})
    lr, cr = prefill_with(m32, p0, {s: kernel_pair(k)[1]
                                    for s, k in kernels.items()})
    lc, cc = prefill_with(m32, p0, {s: bf16_operands(k)
                                    for s, k in kernels.items()
                                    if k in MODEL_DTYPE_ARGS})
    got = {"logits_rel_err_f32": rel_err(lk, lr),
           "state_rel_err_f32": rel_err(ck[key], cr[key]),
           "control_logits_rel_err_f32": rel_err(lc, lr),
           "control_state_rel_err_f32": rel_err(cc[key], cr[key])}
    srv = BatchedServer(m32, slots=4, max_len=max_len, aot=False)
    reqs = [srv.submit(p, max_new=max_new) for p in prompts]
    srv.run()
    ties = []
    for r in reqs:
        ref = [int(t) for t in generate(m32, r.prompt[None],
                                        max_new=max_new)[0]]
        if r.tokens == ref:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r.tokens, ref)) if a != b)
        seq = torch.as_tensor(np.concatenate([r.prompt, ref[:i]]),
                              dtype=torch.long, device="cuda")[None]
        lg, _ = prefill_with(m32, seq, {})
        ties.append({"rid": r.rid, "step": i, "generate": ref[i],
                     "served": r.tokens[i],
                     "gap": ((lg[ref[i]] - lg[r.tokens[i]]).abs()
                             / lg.abs().max()).item()})
    del m32, srv
    got.update(generate_agreement_f32=1 - len(ties) / len(reqs),
               near_ties_f32=ties)
    print(f"{arch}: in float32 on the served weights, prefill (prompt of "
          f"{len(prompts[probe])}) through the kernels vs plain, relative "
          f"to the largest magnitude: logits "
          f"{got['logits_rel_err_f32']:.3g}, final {key} state "
          f"{got['state_rel_err_f32']:.3g} (tol {RECURRENT_F32_RTOL} each);"
          f" control, the kernels on bf16 operands: "
          f"{got['control_logits_rel_err_f32']:.3g} and "
          f"{got['control_state_rel_err_f32']:.3g}; {len(reqs) - len(ties)}"
          f"/{len(reqs)} served requests equal generate()" + "".join(
              f"; request {t['rid']} first differs at step {t['step']}, at "
              f"a logit gap of {t['gap']:.3g} of the largest" for t in ties),
          flush=True)
    if max(got["logits_rel_err_f32"], got["state_rel_err_f32"]) \
            > RECURRENT_F32_RTOL:
        fail(f"{arch}: prefill through the kernels differs in float32: "
             f"{got}")
    if min(got["control_logits_rel_err_f32"],
           got["control_state_rel_err_f32"]) <= RECURRENT_F32_RTOL:
        fail(f"{arch}: the control reads within the float32 gate, which so "
             f"cannot tell bf16 operands from sound ones: {got}")
    if [t for t in ties if t["gap"] > RECURRENT_F32_RTOL]:
        fail(f"{arch}: served requests leave generate() in float32 where "
             f"it is no near-tie: {ties}")
    return got


SERVE_MAX_NEW = 16
# new tokens the recurrent models' generate() checks decode (their served
# requests decode SERVE_MAX_NEW): each generate() step is a host-bound
# eager decode of 32 layers, so these are cut for the run's time cap
RECURRENT_CHECK_NEW = {"float32": 8, "bfloat16": 4}


def served_model(arch, n_layers=None, param_dtype=None, kv_quant=False):
    """``arch`` at full width on the card, at full depth or cut to
    ``n_layers``, in the config's dtype or ``param_dtype``, its weights drawn
    from a generator seeded 0 on the card (the same weights in every
    phase)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              param_dtype=param_dtype or cfg.param_dtype)
    model = get_model(cfg, device="cuda",
                      **({"kv_quant": True} if kv_quant else {}))
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model


def serve_workload(cfg):
    """The 8 prompts a served model answers, as (lengths, prompts, max_len,
    index of the prompt the checks prefill)."""
    if cfg.family in STATE_KEY:  # exact-length packing: pads corrupt a state
        rng = np.random.default_rng(9 if cfg.family == "ssm" else 10)
        lengths = rng.integers(8, 129, size=8)
        lengths[2] = 256                     # a multi-chunk prompt
        max_len, probe = 272, 2
    else:                        # padded buckets
        rng = np.random.default_rng(0)
        lengths = rng.integers(8, 201, size=8)
        max_len, probe = 256, 0
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths]
    return lengths, prompts, max_len, probe


def phase_serve(report, arch):
    """Phases 3 (glm4-9b through K2), 9 (rwkv6-7b through K6) and 10
    (hymba-1.5b through K7 and K2): serve the model at full width and depth
    in bf16, check the run, then hold its kernels against their plain
    versions at every (B, S) the run gave them, on its own inputs (for
    glm4-9b that is phase 4).  Returns (launches, recorded calls, checks),
    each by kernel name; the model is freed when the caller collects."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import layer_spec, top_spec
    from repro_torch.serve import BatchedServer, generate

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = served_model(arch)
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    counted = cfg.param_counts()[0] + cfg.d_model  # param_counts omits final_ln
    print(f"{arch}: {cfg.family}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params:,} params ({cfg.param_dtype}, "
          f"{gib:.2f} GiB) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; the config counts {counted:,}",
          flush=True)
    # the layout the model shares with its JAX twin and the converter; the
    # config's own count is exact for the dense family only (it leaves out
    # rwkv6's decay LoRA, lerps and group norm, mamba's conv, dt and skip)
    layout = cfg.n_layers * sum(map(math.prod, layer_spec(cfg).values())) \
        + sum(map(math.prod, top_spec(cfg).values()))
    if n_params != layout or cfg.family == "dense" and n_params != counted:
        fail(f"{arch}: parameter count {n_params} != {layout} of the layout"
             f" ({counted} from the config)")

    kernels = SERVE_SITES[arch]
    sites = {site: FirstCalls(kernel_pair(k)[0]) for site, k in kernels.items()}
    for site, impl in sites.items():
        ops.install(site, site_impl(site, impl), kernel=kernels[site],
                    route="cuda")
    recurrent = cfg.family in STATE_KEY
    lengths, prompts, max_len, probe = serve_workload(cfg)
    max_new = SERVE_MAX_NEW

    # eager (aot=False) serving: every call passes through the wrappers'
    # counters and FirstCalls; phase 16 serves through CUDA graphs
    warm = BatchedServer(model, slots=4, max_len=max_len, aot=False)
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
    srv = BatchedServer(model, slots=4, max_len=max_len, aot=False)
    reqs = [srv.submit(p, max_new=max_new) for p in prompts]
    for s in sites.values():
        s.calls.clear()
    fns = {k: kernel_pair(k)[0] for k in kernels.values()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches = 0                      # the main path's run
        for body in getattr(fn, "launches_by_path", ()):
            fn.launches_by_path[body] = 0
    t = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in fns.items()}
    by_path = {k: dict(fn.launches_by_path) for k, fn in fns.items()
               if hasattr(fn, "launches_by_path")}
    calls = {k: dict(sites[s].calls) for s, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step     # back to the class methods

    bad = [(r.rid, len(r.tokens)) for r in reqs
           if not r.done or len(r.tokens) != max_new]
    if bad:
        fail(f"{arch}: requests without their {max_new} tokens: {bad}")
    if any(not 0 <= tok < cfg.vocab_size for r in reqs for tok in r.tokens):
        fail(f"{arch}: a token outside the vocabulary")
    need = cfg.n_layers * stats["prefill_calls"]
    print(f"{arch}: served {len(reqs)} requests (prompt lengths "
          f"{lengths.tolist()}, "
          f"{'exact-length packing' if recurrent else 'padded buckets'}) in "
          f"{wall:.2f} s: {stats['prefill_calls']} packed prefills, launches "
          f"{launches} ({need} each needed: every layer of every prefill), "
          f"swap epochs {srv.swap_epochs}; by body {by_path}", flush=True)
    if need == 0 or any(n != need for n in launches.values()):
        fail(f"{arch}: kernel launches {launches}, {need} expected")
    # every serving call is bf16 at the config's head_dim
    if (cfg.param_dtype == "bfloat16" and cfg.resolved_head_dim <= 128
            and by_path.get("flash_attention", {}).get("simt")):
        fail(f"{arch}: K2 serving calls on the CUDA cores: {by_path}")
    if by_path.get("ssd", {}).get("simt"):
        fail(f"{arch}: K7 serving calls on the CUDA cores: {by_path}")

    prefill_tokens = int(lengths.sum())
    decode_tokens = sum(len(r.tokens) - 1 for r in reqs)
    serve = {
        "arch": arch, "requests": len(reqs),
        "prompt_lengths": lengths.tolist(), "max_new": max_new, "slots": 4,
        "max_len": max_len, "params": n_params, "param_gib": gib,
        "prefill_calls": stats["prefill_calls"], "launches": launches,
        "launches_by_path": by_path,
        "prefill_tokens": prefill_tokens, "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": prefill_tokens / stats["prefill_s"],
        "decode_tokens": decode_tokens, "decode_s": stats["decode_s"],
        "decode_tokens_per_s": decode_tokens / stats["decode_s"],
        "wall_s": wall, "peak_memory_bytes": peak,
        "tokens": [r.tokens for r in reqs],
    }
    print(f"{arch}: prefill {serve['prefill_tokens_per_s']:.1f} tokens/s "
          f"({prefill_tokens} prompt tokens in {stats['prefill_s']:.3f} s), "
          f"decode {serve['decode_tokens_per_s']:.1f} tokens/s "
          f"({decode_tokens} tokens in {stats['decode_s']:.3f} s), peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)

    # last-token prefill logits (and the final recurrent state) through the
    # kernels vs their plain versions.  glm4-9b's 40 bf16 layers hold
    # LOGITS_RTOL.  Through 32 random recurrent layers two exact plain paths
    # in bf16 (the plain versions, the chunked model path) already differ
    # by amplified rounding flips (PERF.md): printed, and gated in float32
    # on the same weights.
    p0 = torch.as_tensor(prompts[probe], dtype=torch.long,
                         device="cuda")[None]
    plains = {s: kernel_pair(k)[1] for s, k in kernels.items()}
    lk, ck = prefill_with(model, p0, {})
    lr, cr = prefill_with(model, p0, plains)
    key = STATE_KEY.get(cfg.family)
    if not (torch.isfinite(lk).all() and lk.shape == (cfg.vocab_size,)
            and (key is None or bool(torch.isfinite(ck[key]).all()))):
        fail(f"{arch}: prefill logits or state not finite, or logits of "
             f"shape {tuple(lk.shape)}")
    rel = rel_err(lk, lr)
    same_top = int(lk.argmax()) == int(lr.argmax())
    serve.update(logits_rel_err=rel, logits_same_argmax=same_top)
    if not recurrent:
        print(f"{arch}: prefill logits (prompt of {len(prompts[probe])}) "
              f"kernel vs plain: max rel err {rel:.3g} (tol {LOGITS_RTOL}), "
              f"same argmax {same_top}", flush=True)
        if rel > LOGITS_RTOL:
            fail(f"{arch}: prefill logits through the kernel differ by "
                 f"{rel:.3g}")
    else:
        lch, cch = prefill_with(model, p0, dict.fromkeys(plains))
        serve["bf16_rel_err"] = bf16 = {
            "kernel": (rel, rel_err(ck[key], cr[key])),
            "chunked": (rel_err(lch, lr), rel_err(cch[key], cr[key]))}
        print(f"{arch}: in bf16, prefill (prompt of {len(prompts[probe])}) "
              f"vs the plain versions, logits and final {key} state relative"
              f" to their largest magnitude: kernels {bf16['kernel'][0]:.3g}"
              f" and {bf16['kernel'][1]:.3g}, the chunked plain path "
              f"{bf16['chunked'][0]:.3g} and {bf16['chunked'][1]:.3g} (not "
              f"gated), same argmax {same_top}", flush=True)
        print(f"reduced: {arch}'s generate() checks decode "
              f"{RECURRENT_CHECK_NEW['float32']} new tokens a request in "
              f"float32 (gated) and {RECURRENT_CHECK_NEW['bfloat16']} in "
              f"bf16 (not gated), of the {max_new} served (host-bound "
              f"decode, for the run's time cap)", flush=True)
        serve.update(check_recurrent_f32(model, prompts, probe, kernels,
                                         max_len,
                                         RECURRENT_CHECK_NEW["float32"]))

    n_ref = RECURRENT_CHECK_NEW["bfloat16"] if recurrent else max_new
    refs = [[int(tok) for tok in generate(model, r.prompt[None],
                                          max_new=n_ref)[0]]
            for r in reqs]
    agree = sum(r.tokens[:n_ref] == ref for r, ref in zip(reqs, refs))
    first = sum(r.tokens[0] == ref[0] for r, ref in zip(reqs, refs))
    print(f"{arch}: requests equal to generate() on the card over "
          f"{n_ref} tokens: {agree}/{len(reqs)}, first tokens "
          f"{first}/{len(reqs)} (bf16 at other row counts is not "
          "bit-stable; not gated)", flush=True)
    serve.update(generate_agreement=agree / len(reqs),
                 generate_first_token_agreement=first / len(reqs))

    # where a serving step's time goes (outside the counted run): one
    # ragged decode step over 4 live slots, one packed prefill of two
    # 256-token rows (glm4-9b: 160 tokens each, padded)
    cache = model.init_cache(4, max_len)
    toks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([200, 150, 100, 50], device="cuda")
    if recurrent:
        rows, lens = np.stack([prompts[probe]] * 2), None
    else:
        rows = np.pad(np.stack([prompts[probe][:160]] * 2), ((0, 0), (0, 96)))
        lens = torch.tensor([160, 160], device="cuda")
    rows = torch.as_tensor(rows, device="cuda").long()
    with torch.no_grad():
        split = {"decode_step": time_split(
                     lambda: model.decode_step(cache, toks, pos), top=12),
                 "prefill_2x256": time_split(
                     lambda: model.prefill(rows, max_len=max_len,
                                           lengths=lens), top=12)}
    for what, r in split.items():
        print(f"{arch} {what}: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms (busy {r['device_busy_share']:.1%}) "
              f"in {r['kernels_per_call']:.0f} kernels ({r['traces']} traces, "
              f"{r['sentinels_lost']} sentinels lost);"
              " top: " + ", ".join(f"{t['kernel'][:40]} {t['ms']:.3f}"
                                   for t in r["top_kernels"][:3]), flush=True)
    serve["time_split"] = split
    ops.clear_all()

    # the kernels against their plain versions on the run's own inputs
    checks = {}
    for name, by_shape in calls.items():
        checks[name] = []
        for (B, S), (args, kw) in sorted(by_shape.items()):
            if name == "flash_attention":
                r = compare(*args, kw.get("causal", True))
                require_mma(r, f"{arch}'s serving shape B={B} S={S}")
            else:
                r = compare_recurrent(name, args, kw["chunk"])
                if name == "ssd":
                    require_k7_mma([r], f"{arch}'s serving shape B={B} "
                                        f"S={S}")
            checks[name].append(r)
            print(f"  {name} {r['dtype']} B={B} S={S:3d} at the serving "
                  f"run's inputs{' (' + r['path'] + ')' if 'path' in r else ''}"
                  f": max_abs_err {r['max_abs_err']:.3g} (of tol "
                  f"{r['tol_ratio']:.2f})", flush=True)
            if not agrees(r):
                fail(f"{name} disagrees at {arch}'s serving shape: {r}")
    serve["checks"] = checks
    report[f"serve_{arch}"] = serve
    return launches, calls, checks


def main_recurrent_shape(kind, calls):
    """K6/K7 at the serving run's heaviest prefill: errors, CUDA-event times
    of the kernel and the plain version, and the bound.  K7's a_log is
    handed over in f32, as the wrapper hands it to the kernel, so a call is
    one kernel (the model's bf16 a_log costs one more, a conversion)."""
    (args, kw) = max(calls.values(), key=lambda a: a[0][0].shape[0]
                     * a[0][0].shape[1])
    if kind == "ssd":
        args = args[:2] + (args[2].float(),) + args[3:]
    r = compare_recurrent(kind, args, kw["chunk"], timed=True)
    if not agrees(r):
        fail(f"{kind} disagrees at its main shape: {r}")
    return r, (args, {"chunk": kw["chunk"]})


def ssd_one_pass(xh, dt, a_log, B_t, C_t, chunk):
    """The control of K7's gate: the chunked SSD as K7's ``mma`` body forms
    it, but with each f32 operand of its products taken in one pass: in
    bf16 G', the state and the scaled B rounded once to bf16 (the kernel
    adds their lo halves); in f32 every operand rounded once to TF32 (the
    kernel takes three passes).  y in xh's dtype, the state in f32."""
    import torch

    def tf32(x):
        return ((x.contiguous().view(torch.int32) + 0x1000)
                & ~0x1FFF).view(torch.float32)
    one = (lambda x: x.bfloat16().float()) if xh.dtype == torch.bfloat16 \
        else tf32

    def product(a, b, split):
        if xh.dtype == torch.float32:
            return one(a) @ one(b)
        return (one(a) @ b if split == "a" else a @ one(b)) if split \
            else a @ b
    Bb, S, H, P = xh.shape
    c = min(chunk, S)
    neg_a = -torch.exp(a_log.float())
    X, D = xh.float().permute(0, 2, 1, 3), dt.float().permute(0, 2, 1)
    Bm, Cm = B_t.float()[:, None], C_t.float()[:, None]
    y = torch.empty(Bb, H, S, P, device=xh.device)
    state = torch.zeros(Bb, H, P, B_t.shape[2], device=xh.device)
    for t0 in range(0, S, c):
        n = min(c, S - t0)
        x, d = X[:, :, t0:t0 + n], D[:, :, t0:t0 + n]
        b, cc = Bm[:, :, t0:t0 + n], Cm[:, :, t0:t0 + n]
        la = torch.cumsum(neg_a[None, :, None] * d, dim=-1)
        keep = torch.ones(n, n, dtype=torch.bool, device=xh.device).tril()
        G = torch.where(keep, product(cc, b.transpose(-1, -2), None)
                        * torch.exp(la[..., :, None] - la[..., None, :])
                        * d[..., None, :], torch.zeros((), device=xh.device))
        y[:, :, t0:t0 + n] = product(G, x, "a") + product(
            cc, state.transpose(-1, -2), "b") * torch.exp(la)[..., None]
        state = torch.exp(la[..., -1])[..., None, None] * state + product(
            x.transpose(-1, -2),
            (d * torch.exp(la[..., -1:] - la))[..., None] * b, "b")
    return y.permute(0, 2, 1, 3).to(xh.dtype), state


def ssd_gate_ratio(got, want, dtype):
    """The larger of the output's and the final state's ratio to the gate
    (RECURRENT_TOL; the state always f32)."""
    (y, s), (want_y, want_s) = got, want
    return max(recurrent_gate(y, want_y, dtype)[1],
               recurrent_gate(s, want_s, "float32")[1])


def ssd_f32_one_pass_control(args, chunk):
    """The control of K7's f32 gate, as K5's: K7 on f32 xh, B and C
    rounded to TF32 (the error of one TF32 pass on its operands) against
    the plain version on the exact operands, as a ratio to the gate.  It
    must read above 1, or the gate could not tell one TF32 pass from K7's
    three.  The inputs must carry f32 mantissas: bf16 values are exact in
    TF32, so rounding them changes nothing.  Returns (the control's ratio,
    the exact operands' ratio, both calls' body)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd, ssd_plain
    xh, dt, a_log, B_t, C_t = (t.contiguous() for t in args)
    exact = (xh, dt, a_log, B_t, C_t)
    rounded = (tf32(xh), dt, a_log, tf32(B_t), tf32(C_t))
    want = ssd_plain(*exact, chunk=chunk)
    control = ssd_gate_ratio(ssd(*rounded, chunk=chunk), want, "float32")
    three = ssd_gate_ratio(ssd(*exact, chunk=chunk), want, "float32")
    torch.cuda.synchronize()
    return control, three, {k7_path(rounded, chunk), k7_path(exact, chunk)}


def ssd_main_shape_extras(args, kw):
    """At K7's main shape: the body it takes, the ``simt`` body's CUDA-event
    ms on the same inputs, the wrapper's host µs a call, and the one-pass
    control's largest error against the plain version as a ratio to the
    gate (RECURRENT_TOL; output or state, whichever reads higher), beside
    the kernel's; then the f32 control (``ssd_f32_one_pass_control``) at
    the same shape on f32 inputs of phase 8's distributions, which must
    read above 1."""
    import torch
    from repro_torch.kernels import ssd_scan as k7
    chunk = kw["chunk"]
    want = k7.ssd_plain(*args, chunk=chunk)
    dtype = str(args[0].dtype).replace("torch.", "")
    control = ssd_gate_ratio(ssd_one_pass(*args, chunk), want, dtype)
    f32_args = recurrent_inputs("ssd", *args[0].shape[:2], torch.float32,
                                torch.Generator(device="cuda").manual_seed(21))
    f32_control, f32_exact, f32_paths = ssd_f32_one_pass_control(f32_args,
                                                                 chunk)
    out = {"path": k7_path(args, chunk),
           "simt_ms": cuda_ms(lambda: k7.run_body(*args, chunk=chunk,
                                                  path="simt")),
           "host_us_per_call": host_us_per_call(
               lambda: k7.ssd(*args, chunk=chunk)),
           "one_pass_control_tol_ratio": control,
           "f32_one_pass_control_tol_ratio": f32_control,
           "f32_tol_ratio": f32_exact}
    torch.cuda.synchronize()
    print(f"K7 at the main shape ({list(args[0].shape)}, {dtype}, chunk "
          f"{chunk}, {out['path']}): simt body {out['simt_ms']:.4f} ms, "
          f"wrapper host {out['host_us_per_call']:.1f} us a call; one-pass "
          f"control {control:.3g} of the gate; f32 one-pass control (K7 on "
          f"xh, B, C rounded to TF32, {'/'.join(sorted(f32_paths))}) "
          f"{f32_control:.3g} of the gate, the exact f32 operands "
          f"{f32_exact:.3g} (the control must read above 1)", flush=True)
    if f32_paths != {"mma"}:
        fail(f"K7's f32 control ran the {f32_paths} body")
    if f32_exact > 1.0 or f32_control <= 1.0:
        fail(f"K7's f32 gate does not separate one TF32 pass ("
             f"{f32_control:.3g}) from three ({f32_exact:.3g})")
    return out


def phase_table4(report):
    """Phase 11: the paper's Table 4 hotspots on the card.  A Campaign on
    h100 over rwkv_wkv and mamba_ssd (every candidate FE-checked and timed
    through K6 or K7), then each winner's Integrated Speedup into its
    application at full width in float32 over 2 x 256 tokens, against the
    naive plain build (the sequential recurrence)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (Campaign, EvalCache, H100Platform,
                                  PatternStore, ResultsDB, get_case,
                                  integrate)
    from repro_torch.kernels.suites import hpc
    from repro_torch.models import get_model

    platform = H100Platform()
    db_path = OUT.parent / "campaign_table4.jsonl"
    db_path.unlink(missing_ok=True)
    store = PatternStore()
    camp = Campaign(platform, patterns=store, cache=EvalCache(),
                    db=ResultsDB(str(db_path)))
    print(f"Table 4 on {platform.name} (heuristic proposer, D=6 N=3 R=30 "
          "k=3, as phase 5):", flush=True)
    recs = {kind: FirstCalls.at(hpc, kind, lambda *a, **kw: (
        tuple(a[0].shape), str(a[0].dtype), kw.get("chunk")))
        for kind in ("wkv", "ssd")}
    rows = []
    try:
        for name, (kind, arch) in TABLE4_CASES.items():
            kernel, _ = kernel_pair(kind)
            kernel.launches = 0                 # this path's run
            by_path = getattr(kernel, "launches_by_path", {})
            for body in by_path:
                by_path[body] = 0
            res, row = run_case(camp, store, platform, name)
            row["campaign_launches"] = kernel.launches
            status = row["status"]
            print(f"  {name:9s} MEP scale {row['scale']}: baseline "
                  f"{row['baseline_ms']:.4f} ms -> best {row['best_ms']:.4f}"
                  f" ms ({row['speedup']:.3f}x, {row['best_variant']}); "
                  f"{status['ok']} ok of {row['candidates']} evaluated, FE "
                  f"fails {status['fe_fail']}, AER repairs "
                  f"{res.aer_records}; {kind} launches {kernel.launches} "
                  f"({row['seconds']:.1f} s)", flush=True)
            if kernel.launches == 0 or status["ok"] == 0:
                fail(f"{name}: {kernel.launches} {kind} launches, "
                     f"{status['ok']} ok candidates")

            gc.collect()
            torch.cuda.empty_cache()
            cut = TABLE4_CUTS.get(arch)
            cfg = dataclasses.replace(
                get_config(arch), param_dtype="float32",
                n_layers=cut or get_config(arch).n_layers)
            t = time.perf_counter()
            model = get_model(cfg, device="cuda")
            model.init_params(torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            toks = torch.as_tensor(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (2, 256)), device="cuda")
            gib = sum(p.numel() for p in model.parameters()) * 4 / 2**30
            print(f"  {arch} float32 ({cut_line(arch, cut)}, d_model "
                  f"{cfg.d_model}, {gib:.2f} GiB) initialised in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            before = kernel.launches
            t = time.perf_counter()
            ir = integrate.integrated_speedup(
                get_case(name), res.best_variant,
                lambda: (lambda tokens: model.forward(tokens)[0]), (toks,),
                platform=platform, r=5, k=1)
            int_launches = kernel.launches - before
            need = cfg.n_layers * (1 + 5 + 1)   # warmup, 5 reps, the output
            print(f"  integrated speedup of {name} in {arch} (2x256 tokens, "
                  f"f32): naive {ir.baseline_time_s * 1e3:.2f} ms -> "
                  f"{kind} {ir.optimized_time_s * 1e3:.2f} ms per forward = "
                  f"{ir.integrated_speedup:.3f}x, fe_ok {ir.fe_ok} (max abs "
                  f"err {ir.max_abs_err:.3g}); {kind} launches "
                  f"{int_launches} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            if not ir.fe_ok or int_launches < need:
                fail(f"{name} integration: fe_ok {ir.fe_ok}, "
                     f"{int_launches} launches ({need} expected)")
            if by_path:
                print(f"  {kind} launches by body (campaign and "
                      f"integration): {by_path}", flush=True)
                row["launches_by_path"] = dict(by_path)
                if by_path.get("simt"):
                    fail(f"{name}: K7 case or integration calls on the CUDA"
                         f" cores: {by_path}")
            row.update(app=f"{arch} float32, {cfg.n_layers} layers, 2x256 "
                           "tokens",
                       app_baseline_ms=ir.baseline_time_s * 1e3,
                       app_optimized_ms=ir.optimized_time_s * 1e3,
                       integrated_speedup=ir.integrated_speedup,
                       fe_ok=ir.fe_ok, app_max_abs_err=ir.max_abs_err,
                       app_launches=int_launches)
            rows.append(row)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for rec in recs.values():
            rec.restore()
    checks = {}
    for kind, rec in recs.items():
        checks[kind] = []
        for key, (args, kw) in sorted(rec.calls.items(), key=str):
            r = compare_recurrent(kind, args, kw["chunk"])
            checks[kind].append(r)
            print(f"  {kind} {r['dtype']} {r['shape']} chunk {r['chunk']}"
                  + (f" ({r['path']})" if "path" in r else "")
                  + f": max_abs_err {r['max_abs_err']:.3g} (of tol "
                  f"{r['tol_ratio']:.2f})", flush=True)
            if not agrees(r):
                fail(f"{kind} disagrees at the pipeline's shape: {r}")
            if kind == "ssd":
                require_k7_mma([r], "phase 11")
    report["table4"] = {"platform": platform.name, "cases": rows,
                        "checks": checks,
                        "journal": str(db_path.relative_to(ROOT))}
    return checks


# --------------------------------------------------------------------------
# the rest of the paper's suites (phases 12-14): K3, K4 and K5
# --------------------------------------------------------------------------
# the cases whose cuda build launches a hand-written kernel: case → (the
# module that looks the wrapper up, its name there)
SUITE_KERNEL_CASES = {"matrixmultiplication": ("appsdk", "matmul"),
                      "reduction": ("appsdk", "reduce_sum"),
                      "vectoradd": ("appsdk", "elementwise"),
                      "moe_grouped_gemm": ("hpc", "grouped_matmul")}
PAPER_MEAN_SPEEDUP = {"polybench": 5.05, "appsdk": 1.77}   # NVIDIA, paper


def suite_wrappers():
    """name → the wrapper of K1, K3, K4 and K5."""
    from repro_torch.kernels.elementwise import elementwise
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.moe_gemm import grouped_matmul
    from repro_torch.kernels.reduce_sum import reduce_sum
    return {"matmul": matmul, "reduce_sum": reduce_sum,
            "elementwise": elementwise, "grouped_matmul": grouped_matmul}


def suite_key(name):
    """The recorded-call key of each wrapper: shape, dtype and the fitted
    block or tile."""
    from repro_torch.kernels.matmul import fit

    def dtype(t):
        return str(t.dtype).replace("torch.", "")
    if name == "matmul":
        return k1_key
    if name == "reduce_sum":
        return lambda x, block=4096, **_: (
            x.shape[0], dtype(x), fit(block, x.shape[0]))
    if name == "elementwise":
        return lambda fn, *arrs, block=8192, **_: (
            fn.__name__, len(arrs), arrs[0].shape[0], dtype(arrs[0]),
            fit(block, arrs[0].shape[0]))
    return lambda x, w, block_m=128, block_n=128, block_k=128, **_: (
        tuple(x.shape), w.shape[-1], dtype(x), fit(block_m, x.shape[1]),
        fit(block_n, w.shape[-1]), fit(block_k, x.shape[2]))


def phase_suite_kernels(report):
    """Phase 12: a Campaign on the measured h100 platform over the four
    cases whose cuda build launches a hand-written kernel (K1, K3, K4,
    K5), every candidate FE-checked and timed through it."""
    from repro_torch.core import Campaign, EvalCache, H100Platform, \
        PatternStore, ResultsDB
    from repro_torch.kernels.suites import appsdk, hpc

    platform = H100Platform()
    db_path = OUT.parent / "campaign_suites.jsonl"
    db_path.unlink(missing_ok=True)
    store = PatternStore()
    camp = Campaign(platform, patterns=store, cache=EvalCache(),
                    db=ResultsDB(str(db_path)))
    print(f"the suites' kernel cases on {platform.name} (heuristic proposer,"
          " D=6 N=3 R=30 k=3, as phase 5):", flush=True)
    wrappers = suite_wrappers()
    modules = {"appsdk": appsdk, "hpc": hpc}
    recs = {w: FirstCalls.at(modules[m], w, suite_key(w))
            for m, w in SUITE_KERNEL_CASES.values()}
    rows, results, by_path = [], {}, {}
    try:
        for name, (_, wname) in SUITE_KERNEL_CASES.items():
            kernel = wrappers[wname]
            kernel.launches = 0                 # this path's run
            if hasattr(kernel, "cache_hits"):   # K4
                kernel.compiles = kernel.cache_hits = 0
            if hasattr(kernel, "launches_by_path"):     # K1, K5
                kernel.launches_by_path = dict.fromkeys(
                    kernel.launches_by_path, 0)
            res, row = run_case(camp, store, platform, name)
            row["launches"] = kernel.launches
            if hasattr(kernel, "cache_hits"):
                row["compiles"] = kernel.compiles
                row["cache_hits"] = kernel.cache_hits
                if kernel.compiles + kernel.cache_hits != kernel.launches:
                    fail(f"{name}: {kernel.compiles} compiles and "
                         f"{kernel.cache_hits} cache hits of {wname} for "
                         f"{kernel.launches} launches")
            if hasattr(kernel, "launches_by_path"):
                by_path[wname] = dict(kernel.launches_by_path)
                row["launches_by_path"] = by_path[wname]
            rows.append(row)
            results[name] = res
            print(f"  {name:20s} MEP scale {row['scale']}: baseline "
                  f"{row['baseline_ms']:.4f} ms -> best {row['best_ms']:.4f}"
                  f" ms ({row['speedup']:.3f}x, {row['best_variant']}); "
                  f"{row['status']['ok']} ok of {row['candidates']} "
                  f"evaluated, FE fails {row['status']['fe_fail']}, AER "
                  f"repairs {row['aer_repairs']}; {wname} launches "
                  f"{row['launches']} {row.get('launches_by_path', '')}"
                  + (f" ({row['compiles']} compiles, {row['cache_hits']} "
                     f"cache hits)" if "cache_hits" in row else "")
                  + f" ({row['seconds']:.1f} s)", flush=True)
            if row["launches"] == 0 or row["status"]["ok"] == 0:
                fail(f"{name}: {row['launches']} {wname} launches, "
                     f"{row['status']['ok']} ok candidates")
    finally:
        for rec in recs.values():
            rec.restore()
    report["suite_kernels"] = {"platform": platform.name, "cases": rows,
                               "journal": str(db_path.relative_to(ROOT))}
    launches = {w: wrappers[w].launches for _, w in SUITE_KERNEL_CASES.values()}
    launches["matmul_by_path"] = by_path["matmul"]
    launches["grouped_matmul_by_path"] = by_path["grouped_matmul"]
    k4_row = next(row for row in rows if "cache_hits" in row)
    launches["elementwise_cache"] = {"compiles": k4_row["compiles"],
                                     "cache_hits": k4_row["cache_hits"]}
    return launches, {w: rec.calls for w, rec in recs.items()}, results


def reduce_tolerance(x, want):
    """K3 vs its plain version: both sum the same n terms in f32 in
    another order; rounding moves each sum by far less than 2^-20 sum|x|
    (16 ulps of the sum of magnitudes, where the random-walk error of n
    roundings is ~sqrt(n) ulps of a partial sum).  A bf16 total is also
    rounded from f32 on both sides: one ulp (2^-8 |want|) more."""
    import torch
    tol = 2.0 ** -20 * x.float().abs().sum().item()
    if x.dtype == torch.bfloat16:
        tol += 2.0 ** -8 * abs(float(want))
    return tol


def suite_bound(name, args, kw):
    """(bound_ms, bound_by) of K3, K4 or K5 on a call's inputs: the larger
    of the bytes over the HBM rate (each input read once, the output
    written once) and the operations over the peak for the input type (a
    GEMM's, ``gemm_peak``, for K5)."""
    if name == "reduce_sum":
        (x,) = args
        nbytes, flops, dtype = x.element_size() * (x.numel() + 1), \
            x.numel(), "float32"
    elif name == "elementwise":
        arrs = args[1:]
        n = arrs[0].numel()
        nbytes = sum(a.element_size() * n for a in arrs) \
            + arrs[0].element_size() * n
        flops, dtype = n * (len(arrs) - 1), str(arrs[0].dtype)[6:]
    else:
        x, w = args
        E, M, K = x.shape
        N = w.shape[-1]
        nbytes = x.element_size() * (E * M * K + E * K * N + E * M * N)
        flops, dtype = 2 * E * M * K * N, str(x.dtype)[6:]
    peak = gemm_peak(dtype) if name == "grouped_matmul" else PEAK_FLOPS[dtype]
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def compare_suite(name, key, args, kw, timed: bool = False):
    """K3, K4 or K5 against its plain version on one recorded call's
    inputs; K3 also called again (bitwise equal) and on integer-valued
    inputs of the same size (every partial sum exact: bitwise equal).
    With ``timed``, CUDA-event times of the kernel, the plain version and
    the library yardstick (torch.sum, torch.add, torch.bmm) beside the
    bound."""
    import torch
    from repro_torch.kernels.elementwise import elementwise_plain
    from repro_torch.kernels.ref import grouped_matmul_ref
    from repro_torch.kernels.reduce_sum import reduce_sum_plain
    kernel = suite_wrappers()[name]
    pkw = {k: v for k, v in kw.items() if k not in ("device", "keepdim")}
    r = {"kernel": name, "key": [str(k) for k in key]}
    if name == "grouped_matmul":
        got, r["path"] = launch_body(kernel, *args, **kw)
    else:
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
    r["finite"] = bool(torch.isfinite(got).all())
    if name == "reduce_sum":
        (x,) = args
        plain = lambda: reduce_sum_plain(x, **pkw)  # noqa: E731
        library = lambda: torch.sum(x)  # noqa: E731
        want = plain()
        diff = abs(float(got) - float(want))
        r["tol_ratio"] = diff / reduce_tolerance(x, want)
        r["repeat_bitwise_equal"] = bool(torch.equal(got, kernel(*args,
                                                                 **kw)))
        g = torch.Generator(device=x.device).manual_seed(x.numel())
        xi = torch.randint(-2, 3, x.shape, device=x.device,
                           generator=g).to(x.dtype)
        r["integer_bitwise_equal"] = bool(torch.equal(
            kernel(xi, **kw).reshape(()), reduce_sum_plain(xi, **pkw)))
        # the same values one element past a 16-byte boundary: element by
        # element loads, the same grouping, the same bits
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:]
        view.copy_(x)
        r["misaligned_bitwise_equal"] = bool(
            view.data_ptr() % 16 != 0
            and torch.equal(kernel(view, **kw), got))
        if not (r["repeat_bitwise_equal"] and r["integer_bitwise_equal"]
                and r["misaligned_bitwise_equal"]):
            r["tol_ratio"] = float("inf")
    elif name == "elementwise":
        fn, *arrs = args
        plain = lambda: elementwise_plain(fn, *arrs, **pkw)  # noqa: E731
        library = lambda: torch.add(*arrs)  # noqa: E731
        want = plain()
        diff = (got.float() - want.float()).abs()
        # as tests/test_torch_cuda.py: within 2^-22 fn(|args|) (a sum alone
        # is exact: bit for bit)
        terms = fn(*[a.float().abs() for a in arrs])
        r["tol_ratio"] = (diff / (2.0 ** -22 * terms + 1e-30)).max().item()
        diff = diff.max().item()
        if fn.__name__ == "_add":
            r["bitwise_equal"] = bool(torch.equal(got, want))
            if not r["bitwise_equal"]:
                r["tol_ratio"] = float("inf")
    else:
        x, w = args
        plain = lambda: grouped_matmul_ref(x, w)  # noqa: E731
        library = lambda: torch.bmm(x, w)  # noqa: E731
        r["tol_ratio"] = k5_tol_ratio(got, x, w)
        diff = (got.float() - plain().float()).abs().max().item()
    r["max_abs_err"] = diff
    if timed:
        r["ms"] = cuda_ms(lambda: kernel(*args, **kw))
        r["plain_ms"] = cuda_ms(plain)
        r["library_ms"] = cuda_ms(library)
        r["bound_ms"], r["bound_by"] = suite_bound(name, args, kw)
    return r


def k4_launch(args, kw):
    """K4 at its main shape: the kernel (through the wrapper, from its
    cached compiled kernel) and ``torch.add`` in 5 alternated rounds, the
    host µs a call of both, and the loads in the cached kernel's PTX (``ld.global.v4``: 16 bytes a
    thread)."""
    import torch
    from repro_torch.kernels import elementwise as k4
    fn, *arrs = args
    r = alternated({"ms": lambda: k4.elementwise(*args, **kw),
                    "library_ms": lambda: torch.add(*arrs)})
    r["host_us_per_call"] = host_us_per_call(
        lambda: k4.elementwise(*args, **kw))
    r["library_host_us_per_call"] = host_us_per_call(
        lambda: torch.add(*arrs))
    blk, BLOCK, num_warps = k4._grid(kw.get("block", 8192), arrs[0].numel())
    tensors = (torch.empty_like(arrs[0]), *arrs,
               *(arrs[0],) * (k4.MAX_INPUTS - len(arrs)))
    key = k4.launch_key(fn, len(arrs), tensors, blk, BLOCK, num_warps)
    if key not in k4._launches:
        fail(f"K4's main shape has no cached kernel at {key}")
    ptx = k4._launches[key][-1].asm["ptx"]
    r["ptx_loads"] = sorted(set(re.findall(r"ld\.global[.a-z0-9]*", ptx)))
    r["ptx_ld_global_v4"] = any(".v4" in ld for ld in r["ptx_loads"])
    return r


def k5_tol_ratio(got, x, w) -> float:
    """K5 against its plain version, expert by expert, as a ratio to K1's
    gate (``k1_tolerance``, no epilogue)."""
    from repro_torch.kernels.ref import grouped_matmul_ref
    want = grouped_matmul_ref(x, w).float()
    return max((((got[e].float() - want[e]).abs()
                 / k1_tolerance(x[e], w[e], None, want[e], "none", 1.0, 0.0))
                .max().item()) for e in range(x.shape[0]))


def winner_key(case, variant, scale):
    """The recorded-call key (``suite_key``) of the kernel call that the
    case's cuda build makes for ``variant`` at ``scale``, with the builds'
    defaults (block 4096 and 8192, tiles 128)."""
    from repro_torch.kernels.matmul import fit
    from repro_torch.kernels.suites.hpc import _GMM_E, _GMM_K, _GMM_N
    if case == "reduction":
        return (scale, "float32", fit(variant.get("block", 4096), scale))
    if case == "vectoradd":
        return ("_add", 2, scale, "float32",
                fit(variant.get("block", 8192), scale))
    dtype = "bfloat16" if variant.get("compute_dtype") == "bf16" \
        else "float32"
    return ((_GMM_E, scale, _GMM_K), _GMM_N, dtype,
            fit(variant.get("block_m", 128), scale),
            fit(variant.get("block_n", 128), _GMM_N),
            fit(variant.get("block_k", 128), _GMM_K))


def phase_suite_kernel_checks(report, calls, results):
    """Phase 13: K1, K3, K4 and K5 against their plain versions at every
    shape, block or tile and dtype phase 12 gave them, on its inputs; at
    each of K3, K4 and K5's main shape (its case's winner at the MEP
    scale), times beside the bound."""
    import torch
    from repro_torch.kernels.reduce_sum import reduce_sum
    print("K1, K3, K4, K5 vs plain at every call phase 12 gave them, on its "
          "inputs (K3 also repeated, on integer inputs and one element off "
          "16 bytes, bitwise; K1 and K5 with their body: mma = tensor "
          "cores, simt = CUDA cores):", flush=True)
    checks, mains = {}, {}
    for case, (_, name) in SUITE_KERNEL_CASES.items():
        checks[name] = []
        for key, (args, kw) in sorted(calls[name].items(), key=str):
            if name == "matmul":
                r = compare_k1(key, args, kw)
                r["key"] = list(key)
                print_k1(r)
            else:
                r = compare_suite(name, key, args, kw)
                body = f" {r['path']}" if "path" in r else ""
                print(f"  {name} {key}{body}: max_abs_err "
                      f"{r['max_abs_err']:.3g} (of tol "
                      f"{r['tol_ratio']:.2f})", flush=True)
            checks[name].append(r)
            if not agrees(r):
                fail(f"{name} disagrees with its plain version: {r}")
        if name == "matmul":
            require_tensor_cores(checks[name], calls[name],
                                 {case: results[case].best_variant})
            continue
        res = results[case]
        scale, v = mep_scale(res.mep_log), res.best_variant
        key = winner_key(case, v, scale)
        if key not in calls[name]:
            fail(f"{case}'s winner {key} never reached {name}")
        args, kw = calls[name][key]
        if name == "grouped_matmul":
            require_k5_tensor_cores(checks[name])
            main = k5_times(key, args, kw)
        else:
            main = compare_suite(name, key, args, kw, timed=True)
        if name == "reduce_sum":
            # host-clock rates move between calls: 5 alternated rounds
            x = args[0]
            main.update(alternated({
                "ms": lambda: reduce_sum(*args, **kw),
                "library_ms": lambda: torch.sum(x)}))
            main["host_us_per_call"] = host_us_per_call(
                lambda: reduce_sum(*args, **kw))
            main["library_host_us_per_call"] = host_us_per_call(
                lambda: torch.sum(x))
        if name == "elementwise":
            main.update(k4_launch(args, kw))
        if not agrees(main):
            fail(f"{name} disagrees at its main shape: {main}")
        mains[name] = (main, (args, kw))
        print(f"  {name} at {case}'s winner {v} (scale {scale}): kernel "
              f"{main['ms']:.4f} ms, plain {main['plain_ms']:.4f}, library "
              f"{main['library_ms']:.4f}, bound {main['bound_ms']:.4f} "
              f"({main['bound_by']})" + (
                  f"; the cached kernel's PTX loads {main['ptx_loads']}"
                  if name == "elementwise" else "") + (
                  f"; host {main['host_us_per_call']:.1f} us a call (library "
                  f"{main['library_host_us_per_call']:.1f}), rounds "
                  f"{main['rounds']}" if "rounds" in main else ""),
              flush=True)
    k5_fixed = k5_main_shapes()
    report["suite_kernel_checks"] = checks
    report["suite_main_shapes"] = {n: m for n, (m, _) in mains.items()}
    report["k5_main_shapes"] = {d: m for d, (m, _) in k5_fixed.items()}
    return checks, mains, k5_fixed


# K5's main shape in PERF.md: moe_grouped_gemm's largest scale on the
# 128^3 tile, whatever the campaign picks
K5_MAIN_SHAPE = (8, 512, 256, 512)                 # E, M, K, N
K5_MAIN_TILE = {"block_m": 128, "block_n": 128, "block_k": 128}


def alternated(fns, rounds: int = 5, reps=None):
    """CUDA-event ms of each of ``fns`` in ``rounds`` alternated rounds
    (host-clock rates move between calls): the medians, and the rounds
    under "rounds".  ``reps`` names the calls a round of some of them
    (default 20, after 3 warm-up calls; 1 warm-up call where given)."""
    reps = reps or {}
    times = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            times[n].append(cuda_ms(fn, reps=reps[n], warmup=1) if n in reps
                            else cuda_ms(fn))
    out = {n: float(np.median(ms)) for n, ms in times.items()}
    out["rounds"] = times
    return out


def require_k5_tensor_cores(rows):
    """Fails unless every K5 call of phase 12 with a tile in multiples of
    16 (the winner's among them; the case's inputs are contiguous) ran on
    the tensor cores."""
    for r in rows:
        tile = [int(t) for t in r["key"][3:6]]
        if all(t % 16 == 0 for t in tile) and r["path"] != "mma":
            fail(f"K5 ran the {r['path']} body at {r['key']}")


def k5_times(key, args, kw):
    """K5 against its plain version on (x, w), then the kernel (through
    the wrapper), its ``simt`` body on the same inputs and ``torch.bmm`` in
    5 alternated rounds, the plain version, the bound and the wrapper's
    host µs a call."""
    import torch
    from repro_torch.kernels.moe_gemm import grouped_matmul, run_body
    x, w = args
    tile = tuple(int(t) for t in key[3:6])          # fitted (suite_key)
    r = compare_suite("grouped_matmul", key, args, kw, timed=True)
    r.update(alternated({
        "ms": lambda: grouped_matmul(x, w, **kw),
        "simt_ms": lambda: run_body(x, w, tile, "simt"),
        "library_ms": lambda: torch.bmm(x, w)}))
    r["host_us_per_call"] = host_us_per_call(
        lambda: grouped_matmul(x, w, **kw))
    r["library_host_us_per_call"] = host_us_per_call(
        lambda: torch.bmm(x, w))
    return r


def k5_main_shapes():
    """K5 at its fixed main shape (``K5_MAIN_SHAPE`` on ``K5_MAIN_TILE``,
    seeded inputs) in f32 and bf16, timed as ``k5_times``; each must run on
    the tensor cores, and in f32 a TF32 control (K5 on operands rounded to
    TF32, held against the exact operands) must read above the gate."""
    import torch
    from repro_torch.kernels.moe_gemm import grouped_matmul
    E, M, K, N = K5_MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(14)
    x32 = torch.randn(E, M, K, device="cuda", generator=g)
    w32 = torch.randn(E, K, N, device="cuda", generator=g)
    out = {}
    for dtype in ("float32", "bfloat16"):
        x, w = x32.to(getattr(torch, dtype)), w32.to(getattr(torch, dtype))
        kw = dict(K5_MAIN_TILE)
        key = ((E, M, K), N, dtype, 128, 128, 128)
        r = k5_times(key, (x, w), kw)
        if not agrees(r) or r["path"] != "mma":
            fail(f"K5 at its main shape ({dtype}): {r}")
        if dtype == "float32":
            got = grouped_matmul(tf32(x), tf32(w), **kw)
            r["tf32_control_tol_ratio"] = k5_tol_ratio(got, x, w)
            if r["tf32_control_tol_ratio"] <= 1.0:
                fail("the gate does not see one TF32 pass's error at K5's "
                     f"main shape: {r}")
        out[dtype] = (r, ((x, w), kw))
        print(f"  K5 at its main shape E {E} M {M} K {K} N {N} {dtype} "
              f"128^3 ({r['path']}), medians of 5 alternated rounds: kernel "
              f"{r['ms']:.4f} ms, simt body {r['simt_ms']:.4f}, torch.bmm "
              f"{r['library_ms']:.4f} (rounds {r['rounds']}); plain "
              f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}); wrapper host {r['host_us_per_call']:.1f} "
              f"us a call (torch.bmm {r['library_host_us_per_call']:.1f}); "
              f"gate {r['tol_ratio']:.2f}" + (
                  f"; TF32 control {r['tf32_control_tol_ratio']:.2f} of the "
                  "gate (must read above 1)" if dtype == "float32" else ""),
              flush=True)
    return out


# Tables 1-3's depth cuts (the run's time cap): the two cases whose torch
# builds take most of the phase's time run fewer rounds and reps
TABLES_CUTS = {"adi": {"d_rounds": 1, "r": 10},
               "gramschm": {"d_rounds": 1, "r": 10}}
# and adi's MEP pinned at the scale its walk settles on (T_max rejects its
# larger scales, whose probes took ~8 s)
TABLES_PINNED = {"adi": 256}
# the alternated re-timing of phase 14: rounds of REPS calls of the
# baseline, then of the winner; calls above 10 ms take 5 a round
RETIME_ROUNDS, RETIME_REPS = 5, 30


def same_build(f, g) -> bool:
    """Whether two builds run the same code on the same values: one
    function, or functions of one code object whose closures and defaults
    hold equal values (functions compared the same way).  A winner whose
    build is the baseline's can only have won timing spread."""
    if f is g:
        return True
    code = getattr(f, "__code__", None)
    if code is None or code is not getattr(g, "__code__", None):
        return False
    cells = zip(f.__closure__ or (), g.__closure__ or ())
    pairs = [(a.cell_contents, b.cell_contents) for a, b in cells]
    pairs += list(zip(f.__defaults__ or (), g.__defaults__ or ()))
    for a, b in pairs:
        if callable(a) and callable(b):
            if not same_build(a, b):
                return False
        elif a is not b:
            try:
                if not bool(a == b):
                    return False
            except (RuntimeError, ValueError):  # arrays: only the same one
                return False
    return True


def call_times_ms(fn, inputs, reps):
    """CUDA-event ms of ``reps`` calls, each started on an idle card, as
    the measured platforms time a rep."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn(*inputs)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def alternate_builds(case, scale, builds):
    """``builds`` (side -> built function) on the case's seed-0 inputs at
    ``scale``, alternating RETIME_ROUNDS rounds of RETIME_REPS calls (5 a
    round when a call exceeds 10 ms): (calls a round, side -> the round
    medians in ms).  Host-clock rates move up to 5x between calls, so a
    speedup read across calls needs this."""
    import torch
    from repro_torch.core import datagen
    from repro_torch.core.fe import as_tensors
    inputs = as_tensors(datagen.generate(case.input_specs(scale), 0), "cuda")
    with torch.no_grad():
        for f in builds.values():       # warm-up, graph captures included
            f(*inputs)
        reps = RETIME_REPS if max(call_times_ms(f, inputs, 1)[0]
                                  for f in builds.values()) <= 10 else 5
        rounds = {side: [] for side in builds}
        for _ in range(RETIME_ROUNDS):
            for side, f in builds.items():
                rounds[side].append(float(np.median(call_times_ms(
                    f, inputs, reps))))
    return reps, rounds


def retime(case, row):
    """The case's winner against its baseline in one process, alternating
    RETIME_ROUNDS rounds of each on the MEP's scale and seed-0 inputs:
    the median of each side's round medians and their ratio."""
    base_v, win_v = dict(case.baseline_variant), row["best_variant"]
    out = {"winner_is_baseline": win_v == base_v}
    if out["winner_is_baseline"]:
        return out
    fb, fw = (case.build(v, impl="torch") for v in (base_v, win_v))
    out["same_build"] = same_build(fb, fw)
    reps, rounds = alternate_builds(case, row["scale"],
                                    {"baseline": fb, "winner": fw})
    out.update(reps=reps, rounds=rounds,
               baseline_ms=float(np.median(rounds["baseline"])),
               winner_ms=float(np.median(rounds["winner"])))
    out["speedup"] = out["baseline_ms"] / out["winner_ms"]
    return out


def phase_tables(report):
    """Phase 14: Tables 1-3 on the card.  A Campaign on h100-torch, which
    times the torch build on the card as the JAX CPUPlatform times the jnp
    build on its default device, over every PolyBench and APP SDK case and
    moe_grouped_gemm; every case must reach an ok candidate."""
    from repro_torch.core import (Campaign, EvalCache, H100TorchPlatform,
                                  PatternStore, ResultsDB, cases)
    platform = H100TorchPlatform()
    db_path = OUT.parent / "campaign_tables.jsonl"
    db_path.unlink(missing_ok=True)
    store = PatternStore()
    camp = Campaign(platform, patterns=store, cache=EvalCache(),
                    db=ResultsDB(str(db_path)))
    names = [c.name for c in cases("polybench")] + \
        [c.name for c in cases("appsdk")] + ["moe_grouped_gemm"]
    print(f"Tables 1-3 on {platform.name} ({len(names)} cases, heuristic "
          f"proposer, D=6 N=3 R=30 k=3, as phase 5):", flush=True)
    for name, cut in TABLES_CUTS.items():
        print(f"reduced: {name} D 6→{cut['d_rounds']} rounds, R 30→"
              f"{cut['r']} (its torch build takes 50–230 ms a call on the "
              f"card)" + (f"; its MEP pinned at scale {TABLES_PINNED[name]},"
                          " where its walk settles" if name in TABLES_PINNED
                          else ""), flush=True)
    rows = []
    t0 = time.perf_counter()
    from repro_torch.core import OptConfig
    for name in names:
        cut = TABLES_CUTS.get(name)
        _, row = run_case(camp, store, platform, name,
                          cfg=OptConfig(**cut) if cut else None,
                          scale=TABLES_PINNED.get(name))
        row["reduced"] = cut
        rows.append(row)
        print(f"  {row['suite']:9s} {name:20s} MEP scale {row['scale']}: "
              f"baseline {row['baseline_ms']:.4f} ms -> best "
              f"{row['best_ms']:.4f} ms = {row['speedup']:.3f}x "
              f"({row['best_variant']}); {row['status']['ok']} ok of "
              f"{row['candidates']}, FE fails {row['status']['fe_fail']}, "
              f"AER repairs {row['aer_repairs']} ({row['seconds']:.1f} s)",
              flush=True)
        if row["status"]["ok"] == 0:
            fail(f"{name}: no candidate reached status ok on "
                 f"{platform.name}")
    print(f"Tables 1-3 re-timed: each winner against its baseline, "
          f"alternating {RETIME_ROUNDS} rounds in this process (median of "
          f"the round medians, CUDA events):", flush=True)
    from repro_torch.core import get_case
    for row in rows:
        rt = row["retimed"] = retime(get_case(row["case"]), row)
        if rt["winner_is_baseline"]:
            print(f"  {row['case']:20s} winner is the baseline", flush=True)
            continue
        print(f"  {row['case']:20s} baseline {rt['baseline_ms']:.4f} ms, "
              f"winner {rt['winner_ms']:.4f} ms = {rt['speedup']:.3f}x "
              f"({rt['reps']} calls a round)" + (
                  "; the winner's build is the baseline's: timing spread"
                  if rt["same_build"] else ""), flush=True)
    means = {}
    for suite in ("polybench", "appsdk", "hpc"):
        sp = [r["speedup"] for r in rows if r["suite"] == suite]
        # re-timed; a winner that is the baseline, or runs its build, 1x
        rs = [1.0 if r["retimed"]["winner_is_baseline"]
              or r["retimed"]["same_build"] else r["retimed"]["speedup"]
              for r in rows if r["suite"] == suite]
        means[suite] = {"cases": len(sp), "mean": sum(sp) / len(sp),
                        "geomean": float(np.exp(np.mean(np.log(sp)))),
                        "retimed_mean": sum(rs) / len(rs),
                        "retimed_geomean": float(np.exp(np.mean(np.log(
                            rs))))}
        print(f"  {suite}: mean speedup {means[suite]['mean']:.3f}x "
              f"(geometric {means[suite]['geomean']:.3f}x), re-timed "
              f"{means[suite]['retimed_mean']:.3f}x (geometric "
              f"{means[suite]['retimed_geomean']:.3f}x) over "
              f"{len(sp)} cases" + (
                  f"; the paper reports {PAPER_MEAN_SPEEDUP[suite]}x on its "
                  "NVIDIA platform (the paper's figure, not this port's)"
                  if suite in PAPER_MEAN_SPEEDUP else ""), flush=True)
    print(f"Tables 1-3: {len(rows)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    report["tables"] = {"platform": platform.name, "cases": rows,
                        "means": means,
                        "journal": str(db_path.relative_to(ROOT))}


# --------------------------------------------------------------------------
# the paper's search engine on the card (phase 15): population search with
# expert personae, and the LLM proposer behind a scripted transport
# --------------------------------------------------------------------------
# case → (its kernel, the phase whose greedy run gives its figures): two
# cases of one family each, so island migration has a partner
POPULATION_CASES = {"gemm": ("matmul", 5), "2mm": ("matmul", 5),
                    "rwkv_wkv": ("wkv", 11), "mamba_ssd": ("ssd", 11)}
# the persona preambles' markers (the reference's) in a wave's sections
PERSONA_MARKERS = {"TILING": "tiling", "MEMORY-LAYOUT": "memory",
                   "FUSION/RESTRUCTURE": "fusion",
                   "SYNCHRONIZATION/LATENCY": "sync"}
# (persona, wave, reply): the one reply of the scripted transport that
# cannot become candidates
GARBAGE_REPLY = ("fusion", 0, "I'd rather not answer in JSON today.")


class ThreadedCalls(FirstCalls):
    """``FirstCalls`` that also keeps the threads its calls came from."""

    def __init__(self, fn, key):
        super().__init__(fn, key)
        self.threads = set()

    def __call__(self, *args, **kw):
        import threading
        self.threads.add(threading.get_ident())
        return super().__call__(*args, **kw)


def search_kernel(kind):
    """The wrapper of K1 (``matmul``), K6 (``wkv``) or K7 (``ssd``)."""
    from repro_torch.kernels.matmul import matmul
    return matmul if kind == "matmul" else kernel_pair(kind)[0]


def zero_launches(kernel) -> None:
    kernel.launches = 0
    for body in getattr(kernel, "launches_by_path", {}):
        kernel.launches_by_path[body] = 0


def read_launches(kernel):
    return {"total": kernel.launches,
            **getattr(kernel, "launches_by_path", {})}


def add_launches(total, kind, launches) -> None:
    acc = total.setdefault(kind, dict.fromkeys(launches, 0))
    for body, n in launches.items():
        acc[body] += n


def scripted_transport(case, prompts):
    """The LLM personae's endpoint in phase 15: a scripted transport, no
    model.  A wave's request (the batcher's tagged sections) gets one
    answer a section: two variant dicts drawn from the case's variant
    space by a seeded rule (``random.Random`` of case, persona and wave;
    two knobs each), except GARBAGE_REPLY's section, which gets a refusal.
    A repair prompt gets a refusal, so AER repairs the variant."""
    import random
    space = case.variant_space

    def transport(prompt):
        if prompt.startswith("Kernel "):            # LLMProposer.repair
            return "No corrected variant."
        wave = len(prompts)
        prompts.append(prompt)
        sections, cur = {}, None
        for ln in prompt.splitlines():
            if ln.startswith("### "):
                cur = ln.split()[-1]
                sections[cur] = []
            elif cur is not None:
                sections[cur].append(ln)
        answers = {}
        for sid, lines in sections.items():
            text = "\n".join(lines)
            persona = next((p for m, p in PERSONA_MARKERS.items()
                            if m in text), "")
            if (persona, wave) == GARBAGE_REPLY[:2]:
                answers[sid] = GARBAGE_REPLY[2]
                continue
            rng = random.Random(f"{case.name}/{persona}/{wave}")
            answers[sid] = [{k: rng.choice(space[k])
                             for k in rng.sample(sorted(space), 2)}
                            for _ in range(2)]
        return json.dumps(answers)
    return transport


def scripted_llm_proposer(transport, log):
    """An ``LLMProposer`` whose repairs also go to ``transport`` and whose
    personae log what each parsed (a count) or raised (the error's type),
    by (persona, generation)."""
    from repro_torch.core import LLMBatcher, LLMProposer

    class Scripted(LLMProposer):
        def with_persona(self, persona, idx=0):
            return Scripted(None, self.platform, batcher=self.batcher,
                            persona=persona)

        def _chat(self, prompt):
            return transport(prompt)

        def propose(self, case, state, n):
            try:
                out = super().propose(case, state, n)
            except Exception as e:
                log.append((self.persona, state.round, type(e).__name__))
                raise
            log.append((self.persona, state.round, len(out)))
            return out
    # four personae registered: the wave dispatches when all four wait
    return Scripted(None, "h100", batcher=LLMBatcher(
        transport, max_batch=4, linger_s=30.0))


def population_row(res, row):
    """The population search's figures of one case."""
    cands = [c for rl in res.rounds for c in rl.candidates]
    row.update(generations=len(res.rounds), evaluations=len(cands),
               raced_kills=res.raced_kills,
               migrations={"in": res.migrations_in,
                           "joined": res.migrations_joined,
                           "out": res.migrations_out},
               persona_stats=res.persona_stats,
               repaired=sum(c.repairs > 0 for c in cands),
               stop_reason=res.stop_reason)
    return row


def retime_winners(case, scale, greedy_v, pop_v):
    """The greedy and the population winner's ``cuda`` builds in
    RETIME_ROUNDS alternated rounds (``alternate_builds``): medians, the
    rounds' spread and which is faster."""
    builds = {"greedy": case.build(greedy_v, impl="cuda"),
              "population": case.build(pop_v, impl="cuda")}
    reps, rounds = alternate_builds(case, scale, builds)
    med = {side: float(np.median(ms)) for side, ms in rounds.items()}
    spread = {side: [min(ms), max(ms)] for side, ms in rounds.items()}
    return {"same_variant": greedy_v == pop_v,
            "same_build": same_build(builds["greedy"], builds["population"]),
            "reps": reps,
            "rounds": rounds, "greedy_ms": med["greedy"],
            "population_ms": med["population"], "spread": spread,
            "population_over_greedy": med["greedy"] / med["population"],
            "faster": min(med, key=med.get),
            # within the greedy rounds' spread, or faster
            "within_spread": med["population"] <= spread["greedy"][1]}


def phase_population(report):
    """Phase 15: the paper's search engine on the card.  (a) A Campaign on
    h100 with population search (the reference's default PopulationConfig,
    heuristic proposer, one shared PatternStore) over gemm and 2mm (K1),
    rwkv_wkv (K6) and mamba_ssd (K7), each case's figures beside the
    greedy loop's from phases 5 and 11, the two winners re-timed in
    alternated rounds, and K1, K6 and K7 held against their plain versions
    at every shape the phase gave them; (b) mamba_ssd's population winner
    reintegrated into f32 hymba-1.5b; (c) a Campaign over gemm with
    LLMProposer personae behind a scripted transport (no model)."""
    import dataclasses
    import gc
    import threading
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (Campaign, EvalCache, H100Platform,
                                  PatternStore, PopulationConfig, ResultsDB,
                                  get_case, integrate)
    from repro_torch.core.proposer import PERSONAE
    from repro_torch.kernels.suites import hpc, polybench
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    platform = H100Platform()
    pcfg = PopulationConfig()
    db_path = OUT.parent / "campaign_population.jsonl"
    db_path.unlink(missing_ok=True)
    store = PatternStore()
    camp = Campaign(platform, patterns=store, cache=EvalCache(),
                    db=ResultsDB(str(db_path)), population=pcfg)
    print(f"population search on {platform.name}: {pcfg} (heuristic "
          f"proposer, one shared pattern store, R=30 k=3); greedy figures "
          f"from phases 5 and 11 of this run:", flush=True)
    greedy = {r["case"]: r for r in report["campaign"]["cases"]
              + report["table4"]["cases"]}
    recs = {"matmul": ThreadedCalls.at(polybench, "matmul", k1_key),
            **{kind: ThreadedCalls.at(hpc, kind, lambda *a, **kw: (
                tuple(a[0].shape), str(a[0].dtype), kw.get("chunk")))
               for kind in ("wkv", "ssd")}}
    launches, rows, results = {}, [], {}
    try:
        for name, (kind, phase) in POPULATION_CASES.items():
            kernel = search_kernel(kind)
            zero_launches(kernel)                    # this path's run
            res, row = run_case(camp, store, platform, name)
            row = population_row(res, row)
            row["launches"] = read_launches(kernel)
            add_launches(launches, kind, row["launches"])
            results[name] = res
            rows.append(row)
            g = greedy[name]
            print(f"  {name:9s} MEP scale {row['scale']}: {row['generations']}"
                  f" generations, {row['evaluations']} evaluations "
                  f"({row['status']}, {row['repaired']} AER-repaired), "
                  f"timing reps {row['timing_reps']} paid against fixed R "
                  f"{row['timing_reps_fixed']}, raced kills "
                  f"{row['raced_kills']}, migrations {row['migrations']}; "
                  f"{row['seconds']:.1f} s; best {row['best_ms']:.4f} ms "
                  f"({row['speedup']:.3f}x, {row['best_variant']}); "
                  f"{kind} launches {row['launches']}", flush=True)
            print(f"  {'':9s} personae {row['persona_stats']}", flush=True)
            print(f"  {'':9s} greedy (phase {phase}): {g['rounds']} rounds, "
                  f"{g['candidates']} evaluations, timing reps "
                  f"{g['timing_reps']} of {g['timing_reps_fixed']}, raced out"
                  f" {g['raced_out']}; {g['seconds']:.1f} s; best "
                  f"{g['best_ms']:.4f} ms ({g['speedup']:.3f}x, "
                  f"{g['best_variant']})", flush=True)
            if row["launches"]["total"] == 0 or row["status"]["ok"] == 0:
                fail(f"phase 15 {name}: {row['launches']} {kind} launches, "
                     f"{row['status']['ok']} ok candidates")
            if row["launches"].get("simt") and kind == "ssd":
                fail(f"phase 15 {name}: K7 calls on the CUDA cores: "
                     f"{row['launches']}")

        # (b) the mamba_ssd population winner in f32 hymba-1.5b
        gc.collect()
        torch.cuda.empty_cache()
        k7 = search_kernel("ssd")
        cfg = dataclasses.replace(get_config("hymba-1.5b"),
                                  param_dtype="float32")
        model = get_model(cfg, device="cuda")
        model.init_params(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 256)), device="cuda")
        zero_launches(k7)
        t = time.perf_counter()
        ir = integrate.integrated_speedup(
            get_case("mamba_ssd"), results["mamba_ssd"].best_variant,
            lambda: (lambda tokens: model.forward(tokens)[0]), (toks,),
            platform=platform, r=5, k=1)
        int_launches = read_launches(k7)
        add_launches(launches, "ssd", int_launches)
        need = cfg.n_layers * (1 + 5 + 1)       # warmup, 5 reps, the output
        print(f"  integrated speedup of mamba_ssd's population winner "
              f"{results['mamba_ssd'].best_variant} in hymba-1.5b (2x256 "
              f"tokens, f32, phase 11's inputs; its naive leg re-measured "
              f"here, not reused): naive {ir.baseline_time_s * 1e3:.2f} ms "
              f"-> ssd {ir.optimized_time_s * 1e3:.2f} ms per forward = "
              f"{ir.integrated_speedup:.3f}x, fe_ok {ir.fe_ok} (max abs err "
              f"{ir.max_abs_err:.3g}); ssd launches {int_launches} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        if not ir.fe_ok or int_launches["total"] < need \
                or int_launches["simt"]:
            fail(f"phase 15 integration: fe_ok {ir.fe_ok}, ssd launches "
                 f"{int_launches} ({need} expected, all on mma)")
        integration = {"case": "mamba_ssd", "app": "hymba-1.5b float32, "
                       f"{cfg.n_layers} layers, 2x256 tokens",
                       "variant": results["mamba_ssd"].best_variant,
                       "naive_leg": "re-measured",
                       "app_baseline_ms": ir.baseline_time_s * 1e3,
                       "app_optimized_ms": ir.optimized_time_s * 1e3,
                       "integrated_speedup": ir.integrated_speedup,
                       "fe_ok": ir.fe_ok, "max_abs_err": ir.max_abs_err,
                       "launches": int_launches}
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the LLM path: four personae behind a scripted transport
        prompts, log = [], []
        case = get_case("gemm")
        transport = scripted_transport(case, prompts)
        llm = scripted_llm_proposer(transport, log)
        k1 = search_kernel("matmul")
        llm_camp = Campaign(platform, patterns=PatternStore(),
                            cache=EvalCache(),
                            population=PopulationConfig(generations=2))
        zero_launches(k1)
        llm_res, llm_row = run_case(llm_camp, None, platform, "gemm",
                                    proposer=llm)
        llm_row = population_row(llm_res, llm_row)
        llm_row["launches"] = read_launches(k1)
        add_launches(launches, "matmul", llm_row["launches"])
    finally:
        for rec in recs.values():
            rec.restore()
    batcher = llm.batcher
    gens = len(llm_res.rounds)
    sections = [p.count("\n### k") for p in prompts]
    g0 = llm_res.rounds[0].personae
    parsed = sum(n for _, _, n in log if isinstance(n, int))
    proposed = sum(st["proposed"] for rl in llm_res.rounds
                   for p, st in rl.personae.items() if p in PERSONAE)
    cands = [c for rl in llm_res.rounds for c in rl.candidates]
    paid = sum(1 + (c.reps if c.status == "ok" else 0) for c in cands
               if not c.cached)
    print(f"  LLM path (scripted transport, no model) on gemm: {gens} "
          f"generations, {batcher.calls} endpoint calls carrying "
          f"{sections} sections ({batcher.coalesced} prompts); persona "
          f"replies {sorted(log, key=str)}; {parsed} parsed candidates, "
          f"{proposed} entered the waves, {len(cands)} evaluated "
          f"({llm_row['status']}, {llm_row['repaired']} AER-repaired); K1 "
          f"launches {llm_row['launches']} (at least {paid}: one FE check "
          f"and the timing reps of each); best {llm_row['best_ms']:.4f} ms "
          f"({llm_row['speedup']:.3f}x, {llm_row['best_variant']})",
          flush=True)
    if not (batcher.calls == len(prompts) == gens
            and batcher.coalesced == 4 * gens and set(sections) == {4}):
        fail(f"the LLM waves were not one call of four sections each: "
             f"{batcher.calls} calls, {sections} sections, {gens} waves")
    if (GARBAGE_REPLY[0], 0, "ProposalError") not in log \
            or g0[GARBAGE_REPLY[0]].get("errors") != 1 \
            or not any(g0[p]["evaluated"] for p in PERSONAE
                       if p != GARBAGE_REPLY[0]):
        fail(f"the garbage reply was not isolated as a ProposalError: "
             f"{log}, {g0}")
    if parsed != proposed or not cands \
            or llm_row["launches"]["total"] < paid:
        fail(f"the LLM path's parsed candidates were not all FE-checked "
             f"and timed through K1: {parsed} parsed, {proposed} in the "
             f"waves, {len(cands)} evaluated, {llm_row['launches']} K1 "
             f"launches for {paid}")
    main = threading.main_thread().ident
    if any(rec.threads - {main} for rec in recs.values()):
        fail(f"a kernel was launched off the main thread: "
             f"{[rec.threads for rec in recs.values()]}")

    print("  greedy and population winners re-timed (cuda builds, "
          f"{RETIME_ROUNDS} alternated rounds, CUDA events):", flush=True)
    for row in rows:
        case = get_case(row["case"])
        g = greedy[row["case"]]
        rt = row["retimed"] = retime_winners(case, row["scale"],
                                             g["best_variant"],
                                             row["best_variant"])
        print(f"  {row['case']:9s} greedy {rt['greedy_ms']:.4f} ms "
              f"(rounds {rt['spread']['greedy'][0]:.4f}-"
              f"{rt['spread']['greedy'][1]:.4f}), population "
              f"{rt['population_ms']:.4f} ms (rounds "
              f"{rt['spread']['population'][0]:.4f}-"
              f"{rt['spread']['population'][1]:.4f}): {rt['faster']} "
              f"faster, population {rt['population_over_greedy']:.3f}x the "
              f"greedy winner's speed"
              + ("; the same variant" if rt["same_variant"] else
                 "; the same build" if rt["same_build"] else "")
              + f" ({rt['reps']} calls a round)", flush=True)

    checks = {}
    for kind, rec in recs.items():
        checks[kind] = []
        for key, (args, kw) in sorted(rec.calls.items(), key=str):
            if kind == "matmul":
                r = compare_k1(key, args, kw, timed=False)
                r["key"] = list(key)
                if all(t % 16 == 0 for t in key[5:8]) and r["path"] != "mma":
                    fail(f"phase 15 ran K1 on the {r['path']} body at {key}")
            else:
                r = compare_recurrent(kind, args, kw["chunk"])
                if kind == "ssd":
                    require_k7_mma([r], "phase 15")
            checks[kind].append(r)
            if not agrees(r):
                fail(f"{kind} disagrees at phase 15's shape: {r}")
        print(f"  {kind} vs plain at phase 15's {len(checks[kind])} "
              f"shapes: max_abs_err "
              f"{max(r['max_abs_err'] for r in checks[kind]):.3g} (of tol "
              f"{max(r['tol_ratio'] for r in checks[kind]):.2f}), bodies "
              f"{sorted({r.get('path', '-') for r in checks[kind]})}",
              flush=True)
    wall = time.perf_counter() - t0
    print(f"phase 15 wall time: {wall:.1f} s", flush=True)
    report["population"] = {"platform": platform.name,
                            "config": pcfg.to_dict(), "cases": rows,
                            "integration": integration,
                            "llm": {**llm_row, "calls": batcher.calls,
                                    "sections": sections,
                                    "transport": "scripted, no model",
                                    "persona_replies": log},
                            "launches": launches, "wall_s": wall,
                            "journal": str(db_path.relative_to(ROOT))}
    return launches, checks


def device_time_args(name, call):
    """(args, kwargs) of a main-shape call as ``torch.load`` takes them
    back: K4's map (the vectoradd case's ``_add``) is left out."""
    args, kw = call
    return (args[1:] if name == "elementwise" else args), kw


def suite_entries(launches, checks, mains, k5_fixed):
    """The kernels-line entries of K3, K4 and K5: K3 and K4 at their
    case's winner, K5 at its fixed main shape in f32 (``K5_MAIN_SHAPE``),
    with its bf16 and winner figures beside."""
    meta = {"reduce_sum": ("reduce_sum", "cuda",
                           "src/repro_torch/kernels/csrc/reduce_sum.cu",
                           "src/repro/kernels/suites/pallas_lib.py:101"),
            "elementwise": ("elementwise", "triton",
                            "src/repro_torch/kernels/elementwise.py",
                            "src/repro/kernels/suites/pallas_lib.py:125"),
            "grouped_matmul": ("moe_gemm", "cuda",
                               "src/repro_torch/kernels/csrc/moe_gemm.cu",
                               "src/repro/kernels/moe_gemm.py:49")}
    k5 = {d: r for d, (r, _) in k5_fixed.items()}
    out = []
    for name, (entry, route, source, replaces) in meta.items():
        r = k5["float32"] if name == "grouped_matmul" else mains[name][0]
        e = {"name": entry, "route": route, "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": max(c["max_abs_err"]
                                for c in checks[name] + [r]),
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]}
        if name in ("reduce_sum", "elementwise"):
            e.update(device_ms=r["kernel_device_ms"],
                     host_us_per_call=r["host_us_per_call"],
                     library_host_us_per_call=r["library_host_us_per_call"])
        if name == "elementwise":
            e.update(**launches["elementwise_cache"],
                     ptx_ld_global_v4=r["ptx_ld_global_v4"])
        if name == "grouped_matmul":
            win = mains[name][0]
            e.update(
                launches_by_path=launches["grouped_matmul_by_path"],
                main_shape="E 8 M 512 K 256 N 512 float32 128^3",
                main_shape_path=r["path"], device_ms=r["kernel_device_ms"],
                host_us_per_call=r["host_us_per_call"],
                library_host_us_per_call=r["library_host_us_per_call"],
                simt_ms=r["simt_ms"],
                tf32_control_tol_ratio=r["tf32_control_tol_ratio"],
                bfloat16={key: k5["bfloat16"][key] for key in (
                    "path", "ms", "kernel_device_ms", "simt_ms",
                    "library_ms", "bound_ms", "host_us_per_call")},
                winner={"key": win["key"], "path": win["path"],
                        "ms": win["ms"],
                        "device_ms": win["kernel_device_ms"],
                        "simt_ms": win["simt_ms"],
                        "library_ms": win["library_ms"],
                        "bound_ms": win["bound_ms"]})
        out.append(e)
    return out


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
    from repro_torch.kernels.rwkv_wkv import wkv
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.kernels.suites.appsdk import _add
    kernels = {"flash_attention": flash_attention, "wkv": wkv, "ssd": ssd,
               **suite_wrappers()}
    out = []
    for name, args, kw in torch.load(path):
        if name == "elementwise":       # saved without the map: the case's
            args = (_add, *args)
        split = time_split(lambda: kernels[name](*args, **kw),
                           kernels_per_call=1)
        out.append({key: split[key] for key in
                    ("device_ms", "traces", "sentinels_lost")})
    print(json.dumps(out), flush=True)


def k2_shape_times(q, k, v, causal, calls):
    """K2 at one shape: the kernel (through the wrapper), its ``simt``
    body, the plain version and SDPA (a yardstick) in 5 alternated rounds,
    the wrapper's host µs a call over ``calls`` calls, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     run_body)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = alternated({
        "ms": lambda: flash_attention(q, k, v, causal=causal),
        "simt_ms": lambda: run_body(q, k, v, causal=causal, path="simt"),
        "plain_ms": lambda: flash_attention_ref(q, k, v, causal=causal),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)})
    out["host_us_per_call"] = host_us_per_call(
        lambda: flash_attention(q, k, v, causal=causal), calls=calls)
    B, S, H, hd = q.shape
    out["bound_ms"], out["bound_by"] = attention_bound(
        B, S, k.shape[1], H, k.shape[2], hd,
        str(q.dtype).replace("torch.", ""), causal)
    out["path"] = k2_path(q, k, v)
    return out


def k2_main_shape_times(q, k, v, causal):
    """At K2's main shape: ``k2_shape_times`` (host µs over 1000 calls)
    and the P-in-bf16 control."""
    out = k2_shape_times(q, k, v, causal, calls=1000)
    out["p_bf16_control_tol_ratio"] = p_bf16_control(q, k, v, causal)
    print(f"K2 at the main shape (B={q.shape[0]}, S={q.shape[1]}, "
          f"{str(q.dtype)[6:]}, {out['path']}), medians of 5 alternated "
          f"rounds: kernel {out['ms']:.4f} ms, simt body {out['simt_ms']:.4f}"
          f", plain {out['plain_ms']:.4f}, sdpa {out['library_ms']:.4f} "
          f"(rounds {out['rounds']}); wrapper host "
          f"{out['host_us_per_call']:.1f} us a call; P-in-bf16 control "
          f"{out['p_bf16_control_tol_ratio']:.2f} of the gate (must read "
          "above 1)", flush=True)
    if out["p_bf16_control_tol_ratio"] <= 1.0:
        fail("the gate does not see a one-pass bf16 P at the main shape")
    return out


# --------------------------------------------------------------------------
# online reintegration (phase 16): BatchedServer on CUDA graphs, the serve
# autotuner, guarded installs and rollbacks, FixedBatchServer
# --------------------------------------------------------------------------
def serve_wave(srv, prompts, max_new=SERVE_MAX_NEW):
    """Serve ``prompts`` to the end; each request's tokens."""
    reqs = [srv.submit(p, max_new=max_new) for p in prompts]
    srv.run()
    bad = [(r.rid, len(r.tokens)) for r in reqs
           if not r.done or len(r.tokens) != max_new]
    if bad:
        fail(f"requests without their {max_new} tokens: {bad}")
    return [r.tokens for r in reqs]


def timed_server(srv):
    """Wraps ``srv``'s prefill and decode calls to add their synchronised
    host seconds to ``srv.stats``, and its prefill calls."""
    import torch
    srv.stats = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_calls": 0}
    for name, key in (("_prefill", "prefill_s"), ("_decode", "decode_s")):
        def call(*a, _real=getattr(srv, name), _key=key):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _real(*a)
            torch.cuda.synchronize()
            srv.stats[_key] += time.perf_counter() - t
            srv.stats["prefill_calls"] += _key == "prefill_s"
            return out
        setattr(srv, name, call)
    return srv


def graph_server(model, max_len):
    """A BatchedServer on CUDA graphs (4 slots), with its captures, their
    seconds and the memory they took."""
    import torch
    from repro_torch.serve import BatchedServer
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = timed_server(BatchedServer(model, slots=4, max_len=max_len))
    srv.graph_bytes = torch.cuda.memory_allocated() - before
    srv.peak_bytes = torch.cuda.max_memory_allocated()
    return srv


def graph_against_eager(arch, model, prompts, max_len, rounds):
    """The graph server and the eager one (``aot=False``) serve ``prompts``
    in ``rounds`` alternated rounds (host-clock rates move between calls):
    decode and prefill tokens/s of each, their medians, and every round's
    tokens, which must repeat.  Returns (graph server, readings)."""
    from repro_torch.serve import BatchedServer
    graph = graph_server(model, max_len)
    eager = timed_server(BatchedServer(model, slots=4, max_len=max_len,
                                       aot=False))
    print(f"{arch}: graph server built: {graph.aot_compiles} captures in "
          f"{graph.capture_s:.2f} s, {graph.graph_bytes / 2**20:.1f} MiB "
          f"for its graphs and buffers, peak memory "
          f"{graph.peak_bytes / 2**30:.2f} GiB", flush=True)
    prefill_tokens = int(sum(len(p) for p in prompts))
    decode_tokens = len(prompts) * (SERVE_MAX_NEW - 1)
    rates = {"graph": [], "eager": []}
    tokens = {"graph": None, "eager": None}
    for i in range(rounds):
        for kind in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            srv = graph if kind == "graph" else eager
            srv.stats.update(prefill_s=0.0, decode_s=0.0)
            t = time.perf_counter()
            got = serve_wave(srv, prompts)
            wall = time.perf_counter() - t
            if tokens[kind] is None:
                tokens[kind] = got
            elif got != tokens[kind]:
                fail(f"{arch}: the {kind} server's tokens changed between "
                     f"rounds")
            rates[kind].append({
                "decode_tokens_per_s": decode_tokens / srv.stats["decode_s"],
                "prefill_tokens_per_s": prefill_tokens
                / srv.stats["prefill_s"],
                "wall_tokens_per_s": len(prompts) * SERVE_MAX_NEW / wall,
                "wall_s": wall})
    med = {kind: {key: float(np.median([r[key] for r in rs]))
                  for key in rs[0]} for kind, rs in rates.items()}
    same = sum(a == b for a, b in zip(tokens["graph"], tokens["eager"]))
    out = {"captures": graph.aot_compiles, "capture_s": graph.capture_s,
           "graph_bytes": graph.graph_bytes, "peak_bytes": graph.peak_bytes,
           "rounds": rates, "median": med, "tokens": tokens,
           "graph_equals_eager": same}
    g, e = med["graph"], med["eager"]
    print(f"{arch}: medians of {rounds} alternated rounds, graph | eager: "
          + ", ".join(f"{what} {g[key]:.1f} | {e[key]:.1f} tokens/s "
                      f"({g[key] / e[key]:.2f}x)" for what, key in (
                          ("decode", "decode_tokens_per_s"),
                          ("prefill", "prefill_tokens_per_s")))
          + f", wall {g['wall_s']:.3f} | {e['wall_s']:.3f} s; {same}/"
          f"{len(prompts)} requests with equal tokens", flush=True)
    return graph, out


def graph_prefill_logits(model, prompt, bucket, max_len):
    """Last-token logits of ``prompt`` padded to ``bucket``, as the served
    prefill graph computes them: captured in a CUDA graph and replayed,
    beside the eager call's."""
    import torch
    vocab = model.cfg.vocab_size
    toks = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device="cuda")
    lens = torch.tensor([len(prompt)], device="cuda")
    with torch.no_grad():
        eager = model.prefill(toks, max_len=max_len, lengths=lens)[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.prefill(toks, max_len=max_len, lengths=lens)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            logits = model.prefill(toks, max_len=max_len, lengths=lens)[0]
        g.replay()
        torch.cuda.synchronize()
    return logits[0, -1, :vocab].clone(), eager[0, -1, :vocab]


def replay_split(srv, key, top=6):
    """``time_split`` of one replay of ``srv``'s graph ``key``."""
    graph = srv._graphs[key][0]
    return time_split(graph.replay, top=top)


def print_split(arch, what, r):
    print(f"{arch} {what}: wall {r['wall_ms']:.2f} ms, device "
          f"{r['device_ms']:.2f} ms (busy {r['device_busy_share']:.1%}) in "
          f"{r['kernels_per_call']:.0f} kernels ({r['traces']} traces, "
          f"{r['sentinels_lost']} sentinels lost); top: " + ", ".join(
              f"{t['kernel'][:40]} {t['ms']:.3f}"
              for t in r["top_kernels"][:3]), flush=True)


def autotuner(platform, db, **cfg):
    from repro_torch.core import EvalCache
    from repro_torch.serve import AutotuneConfig, ServeAutotuner
    return ServeAutotuner(platform, config=AutotuneConfig(**cfg),
                          cache=EvalCache(), db=db)


# the forced installs' guard probes: a same-kernel swap reads the probe's
# spread.  A 2 x 256 glm4 prefill is host-bound (56 ms of wall, 22.7 of
# device) and read 0.61x-1.33x K2 over K2, past the 1.25x limit (PERF.md);
# 16 rows make the probe device-bound, and 15 calls trimmed by 3 at each
# end steady the mean
GUARD_R, GUARD_K, GUARD_ROWS = 15, 3, 16


def probe_ratio(g):
    """Installed over baseline probe time of a ``GuardedInstall``."""
    return (g.probe_installed_s / g.probe_baseline_s
            if g.probe_baseline_s else float("nan"))


def swap_line(g):
    return (f"{g.case_name} {g.variant} at scale {g.scale}: {g.reason} "
            f"(probe {g.probe_baseline_s * 1e3:.2f} -> "
            f"{g.probe_installed_s * 1e3:.2f} ms, generation "
            f"{g.generation_before} -> {g.generation})")


def phase_online(report):
    """Phase 16: online reintegration at full width.  (a) glm4-9b on CUDA
    graphs against eager serving and phase 3's tokens, replayed steps
    traced, FixedBatchServer as table 9's baseline, one autotune cycle on
    h100 mid-traffic, then a forced guarded install on the same server
    that re-captures mid-traffic; (c) the autotuner's thread beside a
    second wave; (b) rwkv6-7b: guarded installs of rwkv_wkv's K6 build,
    the naive build (rolled back) and a faulty one (refused) mid-traffic;
    (d) hymba-1.5b on CUDA graphs against eager serving."""
    import dataclasses
    import gc
    import torch
    from repro_torch.core import H100Platform, ResultsDB, get_case
    from repro_torch.core.integrate import guarded_install
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import FixedBatchServer, snap_scale

    t0 = time.perf_counter()
    out = report["online"] = {}
    db_path = OUT.parent / "autotune.jsonl"
    db_path.unlink(missing_ok=True)
    db = ResultsDB(str(db_path))
    platform = H100Platform()
    flash = kernel_pair("flash_attention")[0]

    # ---- (a) glm4-9b ---------------------------------------------------
    model = served_model("glm4-9b")
    lengths, prompts, max_len, _ = serve_workload(model.cfg)
    ops.clear_all()
    ops.install("attention", flash, kernel="flash_attention", route="cuda")
    flash.launches = 0                       # this path's run
    graph, a = graph_against_eager("glm4-9b", model, prompts, max_len, 5)
    a["k2_launches"] = flash.launches
    control = a["tokens"]["graph"]
    phase3 = report["serve_glm4-9b"]["tokens"]
    differ = [i for i, (t, e) in enumerate(zip(control, phase3)) if t != e]
    a["differ_from_phase3"] = differ
    for i in differ:
        bucket = graph.bucket_of(len(prompts[i]))
        lg, le = graph_prefill_logits(model, prompts[i], bucket, max_len)
        rel = rel_err(lg, le)
        print(f"glm4-9b: request {i} differs from phase 3's eager tokens "
              f"(graph {control[i][:6]}..., eager {phase3[i][:6]}...); its "
              f"prefill logits graph vs eager: max rel err {rel:.3g} (tol "
              f"{LOGITS_RTOL})", flush=True)
        if rel > LOGITS_RTOL:
            fail(f"glm4-9b: graph prefill logits of request {i} differ by "
                 f"{rel:.3g}")
    print(f"glm4-9b: graph tokens equal phase 3's eager tokens in "
          f"{len(prompts) - len(differ)}/{len(prompts)} requests; "
          f"{a['k2_launches']} K2 launches through the wrapper in the graph "
          f"server's run (captures and their warm-up runs; a replay does "
          f"not pass the wrapper)", flush=True)
    if a["k2_launches"] == 0:
        fail("glm4-9b: K2 was never launched on the graph path")
    a["decode_replay"] = replay_split(graph, ("decode",))
    print_split("glm4-9b", "replayed decode step", a["decode_replay"])
    a["prefill_replay"] = replay_split(graph, ("prefill", 256, 2), top=500)
    print_split("glm4-9b", "replayed prefill, 2 x 256", a["prefill_replay"])
    k2 = [t for t in a["prefill_replay"]["top_kernels"]
          if "fa_mma_kernel" in t["kernel"]]
    print(f"glm4-9b: K2 in the replayed prefill's trace: {k2}", flush=True)
    if not k2:
        fail("the replayed prefill graph's trace names no fa_mma_kernel")
    a["prefill_replay"]["top_kernels"] = \
        a["prefill_replay"]["top_kernels"][:6]

    longest = int(max(lengths))
    fixed = FixedBatchServer(model, slots=4, prompt_len=longest,
                             max_len=max_len)
    padded = [np.pad(p, (0, longest - len(p))) for p in prompts]
    serve_wave(fixed, padded[:2], max_new=2)           # warm
    t = time.perf_counter()
    serve_wave(fixed, padded)
    wall = time.perf_counter() - t
    a["fixed_batch"] = {"wall_s": wall, "prompt_len": longest,
                        "wall_tokens_per_s": len(prompts) * SERVE_MAX_NEW
                        / wall}
    print(f"glm4-9b: FixedBatchServer (table 9's baseline: prompts padded to "
          f"{longest}, one prefill a request, one shared decode position) "
          f"{a['fixed_batch']['wall_tokens_per_s']:.1f} tokens/s over "
          f"{wall:.3f} s; continuous, median: graph "
          f"{a['median']['graph']['wall_tokens_per_s']:.1f}, eager "
          f"{a['median']['eager']['wall_tokens_per_s']:.1f}", flush=True)
    del fixed

    # one autotune cycle on h100 over the observed attention@b* sites,
    # requests in flight on the graph server
    ops.telemetry.reset()
    reqs = [graph.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    graph.step()
    graph.step()
    tuner = autotuner(platform, db, min_tokens=64)
    rep = tuner.run_once()
    graph.run()
    if [r.tokens for r in reqs] != control:
        fail("glm4-9b: tokens served across the autotune cycle differ from "
             "the control")
    a["autotune"] = {"hot": rep.hot, "wall_s": rep.wall_s,
                     "speedups": [r.speedup for r in rep.results],
                     "swaps": [g.to_dict() for g in rep.swaps],
                     "swap_epochs": graph.swap_epochs}
    print(f"glm4-9b: autotune cycle on h100 mid-traffic in {rep.wall_s:.2f} "
          f"s: hot {rep.hot}, campaign speedups "
          f"{[round(x, 4) for x in a['autotune']['speedups']]}, "
          + ("; ".join(swap_line(g) for g in rep.swaps) or "no install "
             "(no winner beat the incumbent by 1%)")
          + f"; the server saw {graph.swap_epochs} swap epochs; in-flight "
          f"tokens equal the control", flush=True)

    # a forced guarded install on the same server, probed by a served-model
    # prefill: one swap epoch and one re-capture mid-traffic.  The build is
    # K2, as the incumbent, so the guard's reading is the probe's spread
    epochs, built = graph.swap_epochs, graph.aot_compiles
    reqs = [graph.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    graph.step()
    graph.step()
    rows = torch.as_tensor(np.pad(np.stack([prompts[0][:160]] * GUARD_ROWS),
                                  ((0, 0), (0, 96))), device="cuda").long()
    lens = torch.full((GUARD_ROWS,), 160, device="cuda")

    def served_prefill():
        return model.prefill(rows, max_len=max_len, lengths=lens)[0]

    case = get_case("attention_prefill")
    forced = guarded_install(case, dict(case.baseline_variant), scale=256,
                             impl="cuda", probe=served_prefill, r=GUARD_R,
                             k=GUARD_K)
    t = time.perf_counter()
    graph.step()
    pause = time.perf_counter() - t
    graph.run()
    a["forced_install"] = dict(forced.to_dict(), recapture_step_s=pause,
                               swap_epochs=graph.swap_epochs,
                               captures=graph.aot_compiles,
                               probe_ratio=probe_ratio(forced))
    print(f"glm4-9b: forced guarded install, probed by a served prefill "
          f"({GUARD_ROWS} x 256, r={GUARD_R} k={GUARD_K}): "
          f"{swap_line(forced)}, "
          f"installed/baseline {probe_ratio(forced):.3f}; the next step "
          f"re-captured in {pause:.2f} s; swap epochs {epochs} -> "
          f"{graph.swap_epochs}, captures {built} -> {graph.aot_compiles}",
          flush=True)
    if forced.reason != "installed" or graph.swap_epochs != epochs + 1 \
            or graph.aot_compiles != built + a["captures"]:
        fail(f"glm4-9b: the forced install did not swap once: "
             f"{a['forced_install']}")
    if [r.tokens for r in reqs] != control:
        fail("glm4-9b: in-flight tokens across the swap differ from the "
             "control")

    # ---- (c) the autotuner's thread beside a second wave ---------------
    ops.telemetry.reset()
    serve_wave(graph, prompts[:4], max_new=4)          # fresh traffic
    tuner = autotuner(platform, db, min_tokens=64, interval_s=0.2)
    captures = graph.aot_compiles
    reqs = [graph.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    thread = tuner.start()
    step_s = capture_s = None
    try:
        while graph.queue or any(graph.active):
            if step_s is None and tuner._cycle_lock.locked():
                # a registry change while the autotuner works on the card:
                # the server's next step re-captures under the device lock
                ops.install("attention", flash, kernel="flash_attention",
                            route="cuda")
                t, before = time.perf_counter(), graph.capture_s
                graph.step()
                step_s = time.perf_counter() - t
                capture_s = graph.capture_s - before
            else:
                graph.step()
    finally:
        tuner.stop()
    errors = list(db.records("autotune_error"))
    c = {"cycles": len(tuner.reports), "swap_epochs": graph.swap_epochs,
         "captures": graph.aot_compiles - captures,
         "recapture_step_s": step_s, "recapture_s": capture_s,
         "errors": errors,
         "installed": [g.to_dict() for r in tuner.reports
                       for g in r.installed]}
    out["c"] = c
    print(f"glm4-9b: autotuner thread beside a second wave: {c['cycles']} "
          f"cycles, {len(c['installed'])} installs, {c['captures']} "
          f"captures on the main thread"
          + (f" (the step after a registry change mid-cycle took "
             f"{step_s:.2f} s: {capture_s:.2f} s capturing, the rest "
             f"waiting for the device lock and stepping)" if step_s else "")
          + f", thread alive after stop: {thread.is_alive()}", flush=True)
    if thread.is_alive() or errors or [r.tokens for r in reqs] != control:
        fail(f"glm4-9b: the autotuner thread beside serving: {c}")
    out["a"] = a
    laps = out["segment_seconds"] = {"a_c": time.perf_counter() - t0}
    del graph, model, tuner
    ops.clear_all()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) rwkv6-7b --------------------------------------------------
    wkv = kernel_pair("wkv")[0]
    model = served_model("rwkv6-7b")
    lengths, prompts, max_len, probe = serve_workload(model.cfg)
    ops.install("rwkv_wkv", site_impl("rwkv_wkv", wkv), kernel="wkv",
                route="cuda")
    graph, b = graph_against_eager("rwkv6-7b", model, prompts, max_len, 3)
    control = b["tokens"]["graph"]
    m32 = get_model(dataclasses.replace(model.cfg, param_dtype="float32"),
                    device="cuda")
    m32.load_state_dict(model.state_dict())
    p32 = torch.as_tensor(prompts[probe][:64], dtype=torch.long,
                          device="cuda")[None]
    rows32 = torch.as_tensor(np.stack([prompts[probe]] * 2),  # 2 x 256
                             dtype=torch.long, device="cuda")

    def served_prefill32():          # the served weights in f32
        return m32.prefill(p32)[0]

    def served_rows32():             # device-bound: the K6 install's guard
        return m32.prefill(rows32)[0]

    case = get_case("rwkv_wkv")
    ops.telemetry.reset()
    reqs = [graph.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    graph.step()
    graph.step()
    scale = snap_scale(case, ops.telemetry.weighted_scale("attention"))
    wkv.launches = 0
    # K6 at the served chunk, as the incumbent: the guard reads the spread
    k6 = guarded_install(case, {"chunked": True, "chunk": MODEL_CHUNK},
                         scale=scale, impl="cuda", probe=served_rows32,
                         r=GUARD_R, k=GUARD_K)
    k6_fn = ops.get_impl("rwkv_wkv")
    graph.step()
    naive = guarded_install(case, {"chunked": False, "chunk": 64},
                            scale=scale, impl="torch",
                            probe=served_prefill32)
    faulty = guarded_install(dataclasses.replace(
        case, build=lambda v, impl: (
            lambda *x, **kw: case.build(v, impl=impl)(*x, **kw) * 1e3)),
        {"chunked": True, "chunk": 32}, scale=scale, impl="cuda")
    restored = ops.get_impl("rwkv_wkv") is k6_fn \
        and ops.generation("rwkv_wkv") == k6.generation
    graph.run()
    b.update(k6_install=k6.to_dict(), naive_install=naive.to_dict(),
             faulty_install=faulty.to_dict(), swap_epochs=graph.swap_epochs,
             k6_launches=wkv.launches, registry_restored=restored,
             k6_probe_ratio=probe_ratio(k6))
    for what, g in ((f"K6 build (probe 2 x 256 f32, r={GUARD_R} "
                     f"k={GUARD_K})", k6),
                    ("naive build (probe 1 x 64 f32, r=3 k=0)", naive),
                    ("faulty build (x 1e3)", faulty)):
        print(f"rwkv6-7b: {what} mid-traffic: {swap_line(g)}, "
              f"installed/baseline {probe_ratio(g):.3f}", flush=True)
    same = [r.tokens for r in reqs] == control
    print(f"rwkv6-7b: after the three, the registry holds the K6 build "
          f"again: {restored}; swap epochs {graph.swap_epochs}; "
          f"{wkv.launches} K6 launches (served prefills and the guards); "
          f"in-flight tokens equal the control: {same}", flush=True)
    if k6.reason != "installed" or not same:
        fail(f"rwkv6-7b: the K6 build's install: {b['k6_install']}, tokens "
             f"equal the control: {same}")
    if not (naive.rolled_back and naive.reason.startswith("regressed")
            and restored):
        fail(f"rwkv6-7b: the naive build was not rolled back for regression"
             f" with the registry restored: {b['naive_install']}")
    if faulty.installed or not faulty.reason.startswith("fe_fail"):
        fail(f"rwkv6-7b: the faulty build was not refused at FE: "
             f"{b['faulty_install']}")
    if wkv.launches == 0:
        fail("rwkv6-7b: K6 was never launched on the graph server's path")
    b["decode_replay"] = replay_split(graph, ("decode",))
    print_split("rwkv6-7b", "replayed decode step", b["decode_replay"])
    out["b"] = b
    laps["b"] = time.perf_counter() - t0 - sum(laps.values())
    del graph, model, m32
    ops.clear_all()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) hymba-1.5b ------------------------------------------------
    cut = ONLINE_CUTS.get("hymba-1.5b")
    model = served_model("hymba-1.5b", n_layers=cut)
    print(f"hymba-1.5b on graphs: {cut_line('hymba-1.5b', cut)}", flush=True)
    _, prompts, max_len, _ = serve_workload(model.cfg)
    for site, name in SERVE_SITES["hymba-1.5b"].items():
        ops.install(site, site_impl(site, kernel_pair(name)[0]), kernel=name,
                    route="cuda")
    graph, d = graph_against_eager("hymba-1.5b", model, prompts, max_len, 3)
    d["decode_replay"] = replay_split(graph, ("decode",))
    print_split("hymba-1.5b", "replayed decode step", d["decode_replay"])
    out["d"] = d
    del graph, model
    ops.clear_all()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    laps["d"] = out["seconds"] - sum(laps.values())
    print(f"phase 16 (online reintegration) took {out['seconds']:.1f} s: "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in laps.items()),
          flush=True)


# --------------------------------------------------------------------------
# the decoder-only zoo (phase 17): the MoE family, the other dense-path
# configs and the int8 KV cache, served through K2
# --------------------------------------------------------------------------
# layers served of the configs cut in depth (full width): dbrx-132b's 40
# layers are 263 GB in bf16; the other three are cut for the run's time
ZOO_CUTS = {"codeqwen1.5-7b": 4, "stablelm-3b": 4, "chameleon-34b": 4,
            "dbrx-132b": 4}
# the reference's int8-cache check (tests/test_perf_variants.py): logits
# within 0.25 of the exact cache's, argmax equal, over 8 teacher-forced
# steps after 16 prompt tokens
KV_QUANT_ATOL = 0.25


def zoo_k2_checks(arch, calls, fresh=False):
    """K2 against its plain version at every (B, S) of ``calls`` (the first
    call at each), each bf16 call on ``mma``; one line for the lot.  With
    ``fresh``, on seeded normal inputs of each call's shapes and dtype: a
    capture's warm-up prefills zero tokens, whose K/V rows are all equal,
    so attention returns V exactly on any path and could not disagree."""
    import torch
    rows = []
    for (B, S), (args, kw) in sorted(calls.items()):
        if fresh:
            g = torch.Generator(device="cuda").manual_seed(B * 4096 + S)
            args = [torch.randn(a.shape, generator=g, device="cuda",
                                dtype=a.dtype) for a in args[:3]]
        r = compare(*args, kw.get("causal", True))
        require_mma(r, f"{arch}'s serving shape B={B} S={S}")
        if not agrees(r):
            fail(f"K2 disagrees at {arch}'s serving shape: {r}")
        rows.append(r)
    print(f"  K2 against its plain version at {len(rows)} (B, S) of "
          f"{arch}'s run{' (seeded inputs)' if fresh else ''} (H "
          f"{rows[0]['H']}, KV {rows[0]['KV']}, hd "
          f"{rows[0]['hd']}, {rows[0]['dtype']}, bodies "
          f"{sorted({r['path'] for r in rows})}): max_abs_err "
          f"{max(r['max_abs_err'] for r in rows):.3g}, largest tol ratio "
          f"{max(r['tol_ratio'] for r in rows):.2f}", flush=True)
    return rows


def require_k2_mma_launches(arch, flash, dtype) -> None:
    if dtype == "bfloat16" and flash.launches_by_path["simt"]:
        fail(f"{arch}: bf16 K2 launches on the CUDA cores: "
             f"{flash.launches_by_path}")


def cut_line(arch, cut):
    from repro_torch.configs import get_config
    full = get_config(arch).n_layers
    return (f"reduced: n_layers {full}→{cut}" if cut and cut < full
            else f"full depth ({full} layers)")


def routed_prefill(model, tokens, impls):
    """``prefill_with`` that also returns each moe layer's top-k experts,
    as sets (sorted indices) [1, S, K] a layer."""
    from repro_torch.models import layers as L
    real, routes = L.moe_route, []

    def recording(x, p, m):
        out = real(x, p, m)
        routes.append(out[2].sort(dim=-1).values)
        return out
    L.moe_route = recording
    try:
        logits, _ = prefill_with(model, tokens, impls)
    finally:
        L.moe_route = real
    return logits, routes


def routing_flips(a, b) -> int:
    """Tokens whose top-k expert set differs, summed over the layers."""
    return sum(int((x != y).any(dim=-1).sum()) for x, y in zip(a, b))


def moe_gate(model, tokens, flash, plain):
    """Last-token prefill logits of ``tokens`` through K2 against the plain
    version, and the tokens routed to another expert set between the two."""
    import torch
    lk, rk = routed_prefill(model, tokens, {"attention": flash})
    lr, rr = routed_prefill(model, tokens, {"attention": plain})
    if not (torch.isfinite(lk).all() and lk.shape == (model.cfg.vocab_size,)):
        fail(f"{model.cfg.name}: prefill logits not finite or of shape "
             f"{tuple(lk.shape)}")
    return rel_err(lk, lr), routing_flips(rk, rr), len(rk)


def zoo_graph_serve(arch, model, prompts, max_len, flash, cut=None,
                    label=None):
    """``model`` (``arch`` cut to ``cut`` layers) served on CUDA graphs with
    K2 at ``attention`` (its launches counted from zero: every layer of
    every prefill graph, each captured after one warm-up run), K2 held
    against its plain version at every (B, S) of the captures, on seeded
    inputs; prints the rates, captures and peak memory under ``label``.
    Returns the readings."""
    import torch
    from repro_torch.kernels import ops
    cfg = model.cfg
    rec = FirstCalls(flash)
    ops.clear_all()
    ops.install("attention", rec, kernel="flash_attention", route="cuda")
    zero_launches(flash)
    graph = graph_server(model, max_len)
    prefill_graphs = sum(key[0] == "prefill" for key in graph._graphs)
    need = 2 * cfg.n_layers * prefill_graphs
    launches, by_path = flash.launches, dict(flash.launches_by_path)
    if need == 0 or launches != need:
        fail(f"{arch}: {launches} K2 launches in {prefill_graphs} prefill "
             f"captures of {cfg.n_layers} layers, {need} expected")
    require_k2_mma_launches(arch, flash, cfg.param_dtype)
    t = time.perf_counter()
    tokens = serve_wave(graph, prompts)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    label = label or arch
    out = {"arch": arch, "layers": cfg.n_layers, "cut": cut_line(arch, cut),
           "param_gib": gib, "requests": len(prompts),
           "prompt_lengths": [len(p) for p in prompts],
           "captures": graph.aot_compiles, "capture_s": graph.capture_s,
           "k2_launches": launches, "k2_launches_by_path": by_path,
           "decode_tokens_per_s": len(prompts) * (SERVE_MAX_NEW - 1)
           / graph.stats["decode_s"],
           "prefill_tokens_per_s": sum(map(len, prompts))
           / graph.stats["prefill_s"],
           "wall_s": wall, "peak_memory_bytes": peak, "tokens": tokens}
    print(f"{label}: {cfg.family}, {cut_line(arch, cut)}, full width (d_model "
          f"{cfg.d_model}, H {cfg.n_heads}, KV {cfg.n_kv_heads}, hd "
          f"{cfg.resolved_head_dim}), {cfg.param_dtype}, {gib:.2f} GiB: "
          f"{len(prompts)} requests on CUDA graphs ({graph.aot_compiles} "
          f"captures in {graph.capture_s:.2f} s, K2 launched {launches} "
          f"times in them, by body {by_path}) in {wall:.2f} s: decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, prefill "
          f"{out['prefill_tokens_per_s']:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    out["checks"] = zoo_k2_checks(label, rec.calls, fresh=True)
    graph._graphs.clear()
    ops.clear_all()
    return out


def free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_zoo(report):
    """Phase 17: the rest of the decoder-only models through K2.
    qwen2-moe-a2.7b at full width and depth (the main path: eager and
    CUDA-graph serving, K2 launches and checks, the f32 gate with routing
    flips, replayed steps traced), command-r-35b at full width and depth,
    codeqwen1.5-7b, stablelm-3b, chameleon-34b and dbrx-132b at full width
    cut to 4 layers, and the int8 KV cache on codeqwen1.5-7b.  Returns
    (K2 launches, launches by body, checks) of the phase."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchedServer

    t0 = time.perf_counter()
    out = report["zoo"] = {}
    flash, plain = kernel_pair("flash_attention")
    total, checks = {}, []

    # ---- qwen2-moe-a2.7b at full width and depth, bf16 -----------------
    arch = "qwen2-moe-a2.7b"
    free_card()
    model = served_model(arch)
    cfg = model.cfg
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    lengths, prompts, max_len, probe = serve_workload(cfg)
    rec = FirstCalls(flash)
    ops.clear_all()
    ops.install("attention", rec, kernel="flash_attention", route="cuda")
    warm = BatchedServer(model, slots=4, max_len=max_len, aot=False)
    serve_wave(warm, [p[:16] for p in prompts[:2]], max_new=2)
    del warm
    rec.calls.clear()
    eager = timed_server(BatchedServer(model, slots=4, max_len=max_len,
                                       aot=False))
    zero_launches(flash)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eager_tokens = serve_wave(eager, prompts)
    wall = time.perf_counter() - t
    eager_calls = dict(rec.calls)
    q = {"arch": arch, "layers": cfg.n_layers, "param_gib": gib,
         "prompt_lengths": lengths.tolist(), "eager_wall_s": wall,
         "eager_peak_memory_bytes": torch.cuda.max_memory_allocated(),
         "k2_launches": flash.launches,
         "k2_launches_by_path": dict(flash.launches_by_path),
         "prefill_calls": eager.stats["prefill_calls"],
         "eager_decode_tokens_per_s": len(prompts) * (SERVE_MAX_NEW - 1)
         / eager.stats["decode_s"],
         "eager_prefill_tokens_per_s": int(lengths.sum())
         / eager.stats["prefill_s"]}
    add_launches(total, "k2", read_launches(flash))
    need = cfg.n_layers * eager.stats["prefill_calls"]
    print(f"{arch}: moe ({cfg.moe.n_experts} experts, top {cfg.moe.top_k}, "
          f"{cfg.moe.n_shared} shared fused to {cfg.moe.d_ff_shared}), "
          f"full depth ({cfg.n_layers} layers), bf16, {gib:.2f} GiB: an eager"
          f" BatchedServer served {len(prompts)} requests (prompt lengths "
          f"{lengths.tolist()}, padded buckets) in {wall:.2f} s: "
          f"{q['prefill_calls']} packed prefills, K2 launches "
          f"{q['k2_launches']} ({need} needed), by body "
          f"{q['k2_launches_by_path']}; decode "
          f"{q['eager_decode_tokens_per_s']:.1f} tokens/s, prefill "
          f"{q['eager_prefill_tokens_per_s']:.1f} tokens/s, peak memory "
          f"{q['eager_peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
    if need == 0 or flash.launches != need:
        fail(f"{arch}: K2 launches {flash.launches}, {need} expected")
    require_k2_mma_launches(arch, flash, cfg.param_dtype)
    zero_launches(flash)
    graph = graph_server(model, max_len)
    t = time.perf_counter()
    graph_tokens = serve_wave(graph, prompts)
    q.update(graph_wall_s=time.perf_counter() - t,
             captures=graph.aot_compiles, capture_s=graph.capture_s,
             graph_bytes=graph.graph_bytes,
             graph_peak_memory_bytes=torch.cuda.max_memory_allocated(),
             graph_decode_tokens_per_s=len(prompts) * (SERVE_MAX_NEW - 1)
             / graph.stats["decode_s"],
             graph_prefill_tokens_per_s=int(lengths.sum())
             / graph.stats["prefill_s"],
             tokens=graph_tokens,
             graph_equals_eager=sum(a == b for a, b in zip(graph_tokens,
                                                           eager_tokens)))
    add_launches(total, "k2", read_launches(flash))
    require_k2_mma_launches(arch, flash, cfg.param_dtype)
    print(f"{arch}: on CUDA graphs ({graph.aot_compiles} captures in "
          f"{graph.capture_s:.2f} s, {graph.graph_bytes / 2**20:.1f} MiB): "
          f"decode {q['graph_decode_tokens_per_s']:.1f} tokens/s, prefill "
          f"{q['graph_prefill_tokens_per_s']:.1f} tokens/s, peak memory "
          f"{q['graph_peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{q['graph_equals_eager']}/{len(prompts)} requests with the eager"
          f" server's tokens", flush=True)
    if graph_tokens != eager_tokens:
        fail(f"{arch}: the graph server's tokens differ from the eager "
             f"server's")
    q["decode_replay"] = replay_split(graph, ("decode",))
    print_split(arch, "replayed decode step", q["decode_replay"])
    q["prefill_replay"] = replay_split(graph, ("prefill", 256, 2), top=500)
    print_split(arch, "replayed prefill, 2 x 256", q["prefill_replay"])
    k2 = [t for t in q["prefill_replay"]["top_kernels"]
          if "fa_mma_kernel" in t["kernel"]]
    print(f"{arch}: K2 in the replayed prefill's trace: {k2}", flush=True)
    if not k2:
        fail(f"{arch}: the replayed prefill graph's trace names no "
             f"fa_mma_kernel")
    q["prefill_replay"]["top_kernels"] = q["prefill_replay"]["top_kernels"][:8]
    q["checks"] = zoo_k2_checks(arch, eager_calls) + zoo_k2_checks(
        f"{arch} (captures)", {k: c for k, c in rec.calls.items()
                               if k not in eager_calls}, fresh=True)
    checks += q["checks"]
    del graph, eager
    ops.clear_all()
    free_card()
    # the gate: last-token prefill logits, K2 against the plain version.  In
    # bf16 through 24 random layers a router near-tie flips an expert set
    # and the logits with it (printed); gated in float32, converted in place
    # (the bf16 and the f32 model do not fit the card together)
    p0 = torch.as_tensor(prompts[probe], dtype=torch.long,
                         device="cuda")[None]
    rel16, flips16, n_layers = moe_gate(model, p0, flash, plain)
    model.float()
    model.dtype = torch.float32
    model.cfg = cfg = dataclasses.replace(cfg, param_dtype="float32")
    rel, flips, _ = moe_gate(model, p0, flash, plain)
    q.update(bf16_logits_rel_err=rel16, bf16_routing_flips=flips16,
             f32_logits_rel_err=rel, f32_routing_flips=flips,
             f32_peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(f"{arch}: prefill (prompt of {len(prompts[probe])}) through K2 vs "
          f"the plain version, last-token logits relative to the largest: "
          f"float32 {rel:.3g} (tol {RECURRENT_F32_RTOL}), tokens routed to "
          f"another expert set over {n_layers} layers {flips}; bf16 (not "
          f"gated) {rel16:.3g}, {flips16} routed elsewhere; f32 peak memory "
          f"{q['f32_peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
    if rel > RECURRENT_F32_RTOL or flips:
        fail(f"{arch}: float32 prefill through K2 differs: logits {rel:.3g}, "
             f"{flips} routing flips")
    out[arch] = q
    del model
    free_card()

    # ---- command-r-35b at full width and depth, then the depth cuts ----
    for arch in ("command-r-35b", *ZOO_CUTS):
        cut = ZOO_CUTS.get(arch)
        model = served_model(arch, n_layers=cut)
        _, prompts, max_len, _ = serve_workload(model.cfg)
        r = zoo_graph_serve(arch, model, prompts if cut is None
                            else prompts[:4], max_len, flash, cut)
        add_launches(total, "k2", {"total": r["k2_launches"],
                                   **r["k2_launches_by_path"]})
        checks += r["checks"]
        out[arch] = r
        del model
        free_card()

    # ---- the int8 KV cache: codeqwen1.5-7b, 4 layers, float32 ----------
    arch, cut = "codeqwen1.5-7b", ZOO_CUTS["codeqwen1.5-7b"]
    exact = served_model(arch, n_layers=cut, param_dtype="float32")
    quant = served_model(arch, n_layers=cut, param_dtype="float32",
                         kv_quant=True)
    quant.load_state_dict(exact.state_dict())
    ops.clear_all()
    ops.install("attention", flash, kernel="flash_attention", route="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, exact.cfg.vocab_size, (2, 24), generator=g,
                         device="cuda")
    vocab = exact.cfg.vocab_size
    worst, agree = 0.0, 0
    with torch.no_grad():
        _, c0 = exact.prefill(toks[:, :16], max_len=24)
        _, c1 = quant.prefill(toks[:, :16], max_len=24)
        for i in range(16, 24):
            g0, c0 = exact.decode_step(c0, toks[:, i:i + 1], i)
            g1, c1 = quant.decode_step(c1, toks[:, i:i + 1], i)
            g0, g1 = g0[..., :vocab], g1[..., :vocab]
            worst = max(worst, (g0 - g1).abs().max().item())
            agree += int(torch.equal(g0.argmax(-1), g1.argmax(-1)))
    nbytes = {name: sum(t.numel() * t.element_size() for t in c.values())
              for name, c in (("int8", c1), ("exact", c0))}
    bf16 = sum(t.numel() * 2 for t in c0.values())
    kv = {"arch": arch, "cut": cut_line(arch, cut),
          "max_abs_logit_diff": worst, "argmax_equal_steps": agree,
          "cache_bytes_int8": nbytes["int8"],
          "cache_bytes_f32": nbytes["exact"], "cache_bytes_bf16": bf16}
    print(f"{arch}: int8 KV cache, {kv['cut']}, full width, float32: 8 "
          f"teacher-forced steps after 16 prompt tokens (2 rows), largest "
          f"logit difference from the exact cache {worst:.4g} (tol "
          f"{KV_QUANT_ATOL}), argmax equal at {agree}/8 steps; cache bytes "
          f"(2 rows x 24) int8 + bf16 scales {nbytes['int8']:,}, a bf16 "
          f"cache {bf16:,} ({nbytes['int8'] / bf16:.4f} of it; 130/256 = "
          f"{130 / 256:.4f}), this f32 cache {nbytes['exact']:,}", flush=True)
    if worst >= KV_QUANT_ATOL or agree != 8:
        fail(f"{arch}: the int8 cache's decode leaves the exact cache's: {kv}")
    if nbytes["int8"] * 256 != bf16 * 130:
        fail(f"{arch}: the int8 cache holds {nbytes['int8']} bytes, not "
             f"130/256 of {bf16}")
    del exact, c0, c1
    _, prompts, max_len, _ = serve_workload(quant.cfg)
    eager_tokens = serve_wave(BatchedServer(quant, slots=4, max_len=max_len,
                                            aot=False), prompts)
    kv["graph"] = r = zoo_graph_serve(arch, quant, prompts, max_len, flash,
                                      cut, label=f"{arch} (int8 KV cache)")
    kv["graph_equals_eager"] = sum(a == b for a, b in zip(r["tokens"],
                                                          eager_tokens))
    print(f"{arch}: from the int8 cache, {kv['graph_equals_eager']}/"
          f"{len(prompts)} requests on CUDA graphs with the eager server's "
          f"tokens", flush=True)
    if r["tokens"] != eager_tokens:
        fail(f"{arch}: int8-cache graph tokens differ from eager")
    add_launches(total, "k2", {"total": r["k2_launches"],
                               **r["k2_launches_by_path"]})
    checks += r["checks"]
    out["kv_quant"] = kv
    del quant
    ops.clear_all()
    free_card()
    out["seconds"] = time.perf_counter() - t0
    by_path = dict(total["k2"])
    launches = out["k2_launches"] = by_path.pop("total")
    out["k2_launches_by_path"] = by_path
    print(f"phase 17 (the decoder-only zoo) took {out['seconds']:.1f} s; K2 "
          f"launched {launches} times in it, by body {by_path}", flush=True)
    return launches, by_path, checks


# --------------------------------------------------------------------------
# the encoder–decoder family (phase 18): whisper-medium through K2
# --------------------------------------------------------------------------
# whisper-medium's traffic: 4 rows of 1500 frames, prompts of 8 tokens, 32
# new tokens (40 positions, inside the published 448-token context)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 8, 32


def whisper_k2_key(q, k, v, causal=True, **_):
    """(causal, S, T) of a K2 call."""
    return (causal, q.shape[1], k.shape[1])


def phase_whisper(report):
    """Phase 18: whisper-medium (encdec) at full width and depth in bf16,
    served by ``generate()`` with K2 at ``attention``: the launch count and
    bodies, K2 against its plain version at every (causal, S, T) of the run,
    a wrong-mask control, K2 timed at the encoder and decode-cross shapes,
    the serving figures, then the f32 gate.  Returns (K2 launches by body
    with "total", checks, {shape name: (row, call)} for the device times)."""
    import dataclasses
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import run_body
    from repro_torch.models.whisper import (dec_layer_spec, enc_layer_spec,
                                            top_spec)
    from repro_torch.serve import generate

    t0 = time.perf_counter()
    out = report["whisper"] = {}
    flash, plain = kernel_pair("flash_attention")
    B, P, new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    free_card()
    held = torch.cuda.memory_allocated()      # earlier phases' tensors
    model = served_model("whisper-medium")
    cfg = model.cfg
    enc_layers, vocab = cfg.encoder.n_layers, cfg.vocab_size
    n_params = sum(p.numel() for p in model.parameters())
    layout = (enc_layers * sum(map(math.prod, enc_layer_spec(cfg).values()))
              + cfg.n_layers * sum(map(math.prod,
                                       dec_layer_spec(cfg).values()))
              + sum(map(math.prod, top_spec(cfg).values())))
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    if n_params != layout:
        fail(f"whisper-medium: {n_params} parameters, {layout} in the layout")
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn(B, cfg.encoder.n_frames, cfg.d_model, generator=g,
                         device="cuda")
    prompts = np.random.default_rng(0).integers(0, vocab, (B, P)).astype(
        np.int32)
    print(f"whisper-medium: encdec, {enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, H {cfg.n_heads}, hd "
          f"{cfg.resolved_head_dim}, {cfg.encoder.n_frames} frames, "
          f"{n_params:,} params (config's count {cfg.param_counts()[0]:,} "
          f"leaves out the learned positions), {cfg.param_dtype}, {gib:.2f} "
          f"GiB; nothing cut", flush=True)

    rec = FirstCalls(flash, key=whisper_k2_key)
    ops.clear_all()
    ops.install("attention", rec, kernel="flash_attention", route="cuda")
    generate(model, prompts, max_new=2, frames=frames)       # warm-up
    rec.calls.clear()
    zero_launches(flash)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tokens = generate(model, prompts, max_new=new, frames=frames)
    wall = time.perf_counter() - t
    launches = read_launches(flash)
    peak = torch.cuda.max_memory_allocated()
    # the encoder's layers, the decoder's self and cross at prefill, and
    # its cross at each of the new - 1 decode steps
    need = enc_layers + 2 * cfg.n_layers + cfg.n_layers * (new - 1)
    shapes = {(False, cfg.encoder.n_frames, cfg.encoder.n_frames): "encoder",
              (True, P, P): "decoder self, prefill",
              (False, P, cfg.encoder.n_frames): "cross, prefill",
              (False, 1, cfg.encoder.n_frames): "cross, decode"}
    print(f"whisper-medium: generate() of {B} rows ({P}-token prompts, "
          f"{new} new tokens) through K2 at attention in {wall:.2f} s: K2 "
          f"launched {launches['total']} times ({need} needed), by body "
          f"{ {b: n for b, n in launches.items() if b != 'total'} }, at "
          f"(causal, S, T) {sorted(rec.calls)}; peak memory "
          f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
          "earlier phases hold", flush=True)
    if launches["total"] != need or launches["mma"] != need:
        fail(f"whisper-medium: K2 launches {launches}, {need} on mma needed")
    if set(rec.calls) != set(shapes):
        fail(f"whisper-medium: K2 called at {sorted(rec.calls)}, not at "
             f"{sorted(shapes)}")
    if tokens.shape != (B, new) or not ((tokens >= 0) & (tokens < vocab)
                                        ).all():
        fail(f"whisper-medium: generate() gave tokens of shape "
             f"{tokens.shape} outside [0, {vocab})")

    checks = []
    for key, what in shapes.items():
        args, kw = rec.calls[key]
        r = compare(*args, causal=key[0])
        r["shape"] = what
        require_mma(r, f"whisper-medium's {what}")
        if not agrees(r):
            fail(f"K2 disagrees at whisper-medium's {what}: {r}")
        checks.append(r)
        print(f"  K2 vs plain at the {what} (causal {key[0]}, S {key[1]}, "
              f"T {key[2]}, B {r['B']}, H {r['H']}, hd {r['hd']}, "
              f"{r['dtype']}, {r['path']}): max_abs_err "
              f"{r['max_abs_err']:.3g}, {r['tol_ratio']:.2f} of the gate",
              flush=True)
    enc_call = rec.calls[(False, cfg.encoder.n_frames, cfg.encoder.n_frames)]
    q, k, v = enc_call[0]
    control = gate_ratio(run_body(q, k, v, causal=True, path=k2_path(q, k, v)),
                         plain(q, k, v, causal=False))
    print(f"  control: K2 with the causal mask on the encoder's inputs against"
          f" the plain non-causal result reads {control:.3g} of the gate "
          "(must read above 1)", flush=True)
    if control <= 1.0:
        fail("K2's gate does not see a causal mask on the encoder's inputs")

    times = {}
    for name, key in (("encoder", (False, cfg.encoder.n_frames,
                                   cfg.encoder.n_frames)),
                      ("decode_cross", (False, 1, cfg.encoder.n_frames))):
        args = tuple(a.clone() for a in rec.calls[key][0])  # off the cache
        # 200 calls: at the encoder shape 1000 would fill the launch queue
        r = k2_shape_times(*args, causal=False, calls=200)
        r.update(B=B, S=key[1], T=key[2], H=cfg.n_heads, hd=args[0].shape[3])
        times[name] = (r, (args, {"causal": False}))
        print(f"  K2 at whisper's {name} shape (B {B}, S {key[1]}, T "
              f"{key[2]}, H {cfg.n_heads}, hd {r['hd']}, bf16, non-causal, "
              f"{r['path']}), medians of 5 alternated rounds: kernel "
              f"{r['ms']:.4f} ms, simt body {r['simt_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}; wrapper "
              f"host {r['host_us_per_call']:.1f} us a call; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    ptoks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    with torch.no_grad():
        enc_split = time_split(lambda: model.encode(frames))
        pre_split = time_split(lambda: model.prefill(ptoks, frames,
                                                     max_len=P + new))
        _, cache = model.prefill(ptoks, frames, max_len=P + new)
        last = ptoks[:, -1:]
        dec_split = time_split(lambda: model.decode_step(cache, last, P))
    del cache
    out.update(
        params=n_params, param_gib=gib, batch=B, prompt=P, new_tokens=new,
        generate_wall_s=wall, peak_memory_bytes=peak - held,
        held_before_bytes=held, k2_launches=launches,
        k2_calls=[list(key) for key in sorted(rec.calls)],
        causal_mask_control_tol_ratio=control, encoder=enc_split,
        prefill=pre_split, decode_step=dec_split,
        decode_tokens_per_s=B / dec_split["wall_ms"] * 1e3,
        tokens=tokens.tolist(),
        k2_times={n: r for n, (r, _) in times.items()})
    for what, s in (("encoder", enc_split), ("prefill", pre_split),
                    ("decode step", dec_split)):
        print_split("whisper-medium", f"eager {what}", s)
    print(f"whisper-medium: eager decode {out['decode_tokens_per_s']:.1f} "
          f"tokens/s ({B} rows); whole generate() {B * new / wall:.1f} "
          "tokens/s", flush=True)

    # the gate: last-token prefill logits through K2 against its plain
    # version, and generate()'s tokens; in bf16 as a figure (rounding flips
    # through 48 random layers), gated in float32 (K2 on simt), converted in
    # place
    def prefill_logits(impl):
        with ops.use_impl("attention", impl), torch.no_grad():
            logits, _ = model.prefill(ptoks, frames)
        return logits[:, -1, :vocab]

    def served(impl):
        with ops.use_impl("attention", impl):
            return generate(model, prompts, max_new=new, frames=frames)

    rel16 = rel_err(prefill_logits(flash), prefill_logits(plain))
    model.float()
    model.dtype = torch.float32
    model.cfg = dataclasses.replace(cfg, param_dtype="float32")
    rel = rel_err(prefill_logits(flash), prefill_logits(plain))
    zero_launches(flash)
    tok32 = served(flash)
    f32_launches = read_launches(flash)
    same = int(sum((a == b).all() for a, b in zip(tok32, served(plain))))
    out.update(bf16_logits_rel_err=rel16, f32_logits_rel_err=rel,
               f32_rows_equal=same, f32_k2_launches=f32_launches)
    print(f"whisper-medium: prefill through K2 vs the plain version, "
          f"last-token logits relative to the largest: float32 {rel:.3g} "
          f"(tol {RECURRENT_F32_RTOL}); generate() tokens equal in {same}/{B}"
          f" rows (K2 launched {f32_launches['total']} times, on simt "
          f"{f32_launches['simt']}); bf16 (not gated) {rel16:.3g}",
          flush=True)
    if rel > RECURRENT_F32_RTOL or same != B:
        fail(f"whisper-medium: float32 through K2 differs: logits {rel:.3g},"
             f" {same}/{B} rows equal")
    if f32_launches["simt"] != need:
        fail(f"whisper-medium: f32 K2 launches {f32_launches}, {need} on "
             "simt needed")
    del model, rec
    ops.clear_all()
    free_card()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (whisper-medium) took {out['seconds']:.1f} s", flush=True)
    return launches, checks, times


TRAIN_ARCH = "stablelm-3b"       # the reference launcher's default arch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 1024, 2, 8
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=1000)
# (f): the first step's gradients on the card against the CPU's, relative
# plus a share of the largest gradient (f32, TF32 off: summation order
# only); each step's loss and grad norm; the moments against their largest
TRAIN_GRAD_TOL = (1e-4, 1e-5)
TRAIN_METRIC_RTOL = 1e-5
TRAIN_MOMENT_TOL = 1e-4
# (a): the last full-width step's AdamW update of these leaves against a
# float64 recomputation from the step's own inputs (a weight matrix of the
# first and of the last layer, a norm scale that decays, the final norm,
# which does not); the moments within UPDATE_MOMENT_RTOL of their largest;
# each bf16 weight within half a bf16 ulp of the float64 result plus the
# error of UPDATE_F32_ROUNDINGS f32 roundings of its operands (p and
# lr·delta: where they cancel, f32's error is not small against the
# result's ulp), and equal to the result rounded to bf16 but for
# UPDATE_OFF_SHARE of them
UPDATE_LEAVES = ("layers.0.wq", "layers.31.w2", "layers.31.ln1",
                 "top.final_ln")
UPDATE_MOMENT_RTOL = 1e-5
UPDATE_F32_ROUNDINGS = 8
UPDATE_OFF_SHARE = 1e-3
# (a): the held-out batch whose loss is read before the first step and
# after each: 16 rows, one of each of the stream's 16 motifs, from a step
# the training never draws
HELD_ROWS, HELD_STEP = 16, 1000


def train_steps_here(model, opt_cfg, data, steps, device, record=None):
    """``steps`` AdamW steps of ``model`` from fresh moments on ``data``'s
    step-keyed batches: (params, opt state, per-step metrics as floats).
    ``record`` (a dict) receives the first step's gradients."""
    from repro_torch.data import make_global_batch
    from repro_torch.train import init_state, make_train_step, model_params

    def hook(grads):
        if record is not None and not record:
            record.update({n: t.clone() for n, t in grads.items()})
        return grads
    step = make_train_step(model, opt_cfg, grad_hook=hook)
    params = model_params(model)
    opt = init_state(params)
    metrics = []
    for s in range(steps):
        params, opt, m = step(params, opt,
                              make_global_batch(data, s, device=device))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


def update_against_f64(opt_cfg, before, grads, params, opt, metrics):
    """One step's AdamW update of the leaves in ``before`` (their weights
    and moments before the step) against a float64 recomputation from the
    step's inputs: ``grads`` (the step's f32 gradients as the grad hook saw
    them), its grad norm and lr.  Per leaf: the moments' largest error over
    their largest value, the largest weight error in bf16 ulps of the
    float64 result and over its bound (half an ulp plus f32's error on the
    operands), the share of weights off that result rounded to the
    weights' dtype, the share of weights the step changed, and the norm of
    the applied update over the float64 update's."""
    import torch
    from repro_torch.train.optim import decays
    c = opt_cfg
    t = int(opt["step"])
    scale = min(1.0, c.clip_norm / (metrics["grad_norm"] + 1e-9))
    rows = {}
    for n, g in grads.items():
        p0, mu0, nu0 = (before[k][n] for k in ("p", "mu", "nu"))
        g = g * scale
        mu = c.b1 * mu0 + (1 - c.b1) * g
        nu = c.b2 * nu0 + (1 - c.b2) * g * g
        delta = (mu / (1 - c.b1 ** t)) / (torch.sqrt(nu / (1 - c.b2 ** t))
                                          + c.eps)
        if decays(n, params[n]):
            delta = delta + c.weight_decay * p0
        step = metrics["lr"] * delta
        ref = p0 - step
        got = params[n].double()
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(2.0 ** -126))) - 7)
        bound = (ulp / 2 + UPDATE_F32_ROUNDINGS * 2.0 ** -24
                 * (p0.abs() + step.abs()))
        rows[n] = {
            "decays": decays(n, params[n]),
            "mu_rel_err": float((opt["mu"][n].double() - mu).abs().max()
                                / mu.abs().max()),
            "nu_rel_err": float((opt["nu"][n].double() - nu).abs().max()
                                / nu.abs().max()),
            "max_ulps": float(((got - ref).abs() / ulp).max()),
            "err_over_bound": float(((got - ref).abs() / bound).max()),
            "off_rounded_share": float(
                (params[n] != ref.to(params[n].dtype)).double().mean()),
            "changed_share": float((got != p0).double().mean()),
            "update_kept": float((got - p0).norm() / (ref - p0).norm())}
    return rows


def ft_run(path, cfg, state_dict, data, opt_cfg, fail_at):
    """The fault-tolerant loop on the card (reduced model, f32): checkpoint
    every 4 steps, 10 steps, ``fail_at`` failures injected.  Returns (final
    params, restarts, last step)."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_global_batch
    from repro_torch.models import get_model
    from repro_torch.runtime import FailureInjector, FaultTolerantLoop
    from repro_torch.train import init_state, make_train_step, model_params
    model = get_model(cfg, device="cuda")
    model.load_state_dict(state_dict)
    step_fn = make_train_step(model, opt_cfg)
    loop = FaultTolerantLoop(CheckpointManager(path, keep=2),
                             checkpoint_every=4,
                             injector=FailureInjector(fail_at))
    params = model_params(model)

    def one(state, step):
        p, o, m = step_fn(state["params"], state["opt"],
                          make_global_batch(data, step, device="cuda"))
        return {"params": p, "opt": o}, m
    state, final = loop.run({"params": params, "opt": init_state(params)},
                            one, num_steps=10)
    torch.cuda.synchronize()
    return state["params"], loop.restarts, final


def phase_training(report):
    """Phase 19: training on the card.  (a) stablelm-3b trained whole (bf16
    weights, f32 moments, remat) on ``SyntheticLMData``; (b) the hotspots of
    its train step; (c) the trained weights served through K2 by an eager
    BatchedServer, K2 checked on the run's inputs and the prefill logits
    gated against the plain version; (d) a train step through K2 refused;
    (e) the fault-tolerant loop on device tensors (reduced, f32); (f) the
    same two train steps on the card and on the CPU.  Returns (K2 launches
    by body with "total", K2 checks)."""
    import dataclasses
    import math
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import extraction
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.no_backward import NoBackwardKernelError
    from repro_torch.models import get_model
    from repro_torch.serve import BatchedServer
    from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                                   model_params)

    t0 = time.perf_counter()
    out = report["training"] = {}
    flash, _ = kernel_pair("flash_attention")
    ops.clear_all()

    # ---- (a) stablelm-3b whole --------------------------------------------
    free_card()
    held = torch.cuda.memory_allocated()
    model = served_model(TRAIN_ARCH)
    cfg = model.cfg
    params = model_params(model)
    n_params = sum(p.numel() for p in params.values())
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    captured = {}

    def capture(grads):
        if captured.pop("armed", False):
            captured["grads"] = {n: grads[n].double() for n in UPDATE_LEAVES}
        return grads
    step_fn = make_train_step(model, opt_cfg, accum=TRAIN_ACCUM,
                              grad_hook=capture)
    opt = init_state(params)
    data = SyntheticLMData(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    held_out = make_global_batch(
        SyntheticLMData(cfg, TRAIN_SEQ, HELD_ROWS, seed=0), HELD_STEP,
        device="cuda")

    def held_loss():
        with torch.no_grad():
            return float(model.loss(held_out)[0])
    held_losses = [held_loss()]
    first = {n: params[n][:4].clone() for n in ("layers.0.wq", "top.lm_head")}
    torch.cuda.reset_peak_memory_stats()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = []
    for s in range(TRAIN_STEPS):
        batch = make_global_batch(data, s, device="cuda")
        if s == TRAIN_STEPS - 1:
            captured["armed"] = True
            before = {"p": {n: params[n].double() for n in UPDATE_LEAVES},
                      **{k: {n: opt[k][n].double() for n in UPDATE_LEAVES}
                         for k in ("mu", "nu")}}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        row = {"step": s, "ms": ms, **{k: float(v) for k, v in m.items()}}
        held_losses.append(held_loss())
        row["held_loss_after"] = held_losses[-1]
        steps.append(row)
        print(f"{TRAIN_ARCH} train step {s}: loss {row['loss']:.4f} grad "
              f"norm {row['grad_norm']:.4f} lr {row['lr']:.2e} {ms:.1f} ms;"
              f" held-out loss after it {held_losses[-1]:.4f}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    update = update_against_f64(opt_cfg, before, captured.pop("grads"),
                                params, opt, steps[-1])
    del before
    steady = [r["ms"] for r in steps[1:]]
    step_s = sum(steady) / len(steady) / 1e3
    a = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab(),
         "params": n_params, "param_dtype": cfg.param_dtype, "remat": True,
         "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM,
         "opt": TRAIN_OPT, "steps": steps, "steady_step_ms": step_s * 1e3,
         "tokens_per_s": tokens / step_s,
         "bf16_peak_share": 6 * n_params * tokens / (step_s * 989e12),
         "peak_memory_bytes": peak, "memory_held_before_bytes": held,
         "held_out": {"rows": HELD_ROWS, "step": HELD_STEP,
                      "losses": held_losses},
         "update_against_f64": update}
    out["train"] = a
    moved = any(not torch.equal(params[n][:4], t) for n, t in first.items())
    losses = [r["loss"] for r in steps]
    print(f"{TRAIN_ARCH}: trained whole ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab()}, {n_params:,} parameters, bf16 weights, "
          f"f32 moments, remat), global batch {TRAIN_BATCH} x S {TRAIN_SEQ}, "
          f"accum {TRAIN_ACCUM}, {TRAIN_STEPS} steps: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (ln V {math.log(cfg.vocab_size):.4f}); "
          f"steady step {a['steady_step_ms']:.1f} ms (first "
          f"{steps[0]['ms']:.1f}), {a['tokens_per_s']:.1f} tokens/s, "
          f"6·N·tokens at {100 * a['bf16_peak_share']:.1f}% of the bf16 peak "
          f"(989 TFLOP/s), peak memory {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before)", flush=True)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in steps):
        fail(f"{TRAIN_ARCH}: a loss or grad norm is not finite: {steps}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        fail(f"{TRAIN_ARCH}: first loss {losses[0]:.4f} is not within 1.5 "
             f"of ln V")
    if not losses[-1] < losses[0]:
        fail(f"{TRAIN_ARCH}: the loss did not fall: {losses}")
    if not moved:
        fail(f"{TRAIN_ARCH}: the parameters did not move")
    print(f"{TRAIN_ARCH}: held-out loss ({HELD_ROWS} x {TRAIN_SEQ} tokens, "
          f"every motif, stream step {HELD_STEP}) before the first step and "
          f"after each: " + " ".join(f"{x:.4f}" for x in held_losses),
          flush=True)
    if not (math.isfinite(held_losses[-1])
            and held_losses[-1] < held_losses[0]):
        fail(f"{TRAIN_ARCH}: the held-out loss did not fall: {held_losses}")
    print(f"{TRAIN_ARCH}: step {TRAIN_STEPS - 1}'s update against float64 "
          f"AdamW from its inputs (moments rtol {UPDATE_MOMENT_RTOL}, weights"
          f" within half a bf16 ulp plus {UPDATE_F32_ROUNDINGS} f32 roundings"
          f" of their operands, off the rounded result in at most "
          f"{UPDATE_OFF_SHARE} of them):", flush=True)
    for n, r in update.items():
        print(f"  {n:14s} decays {str(r['decays']):5s} mu {r['mu_rel_err']:.3g}"
              f" nu {r['nu_rel_err']:.3g} weights {r['max_ulps']:.3f} ulp "
              f"({r['err_over_bound']:.3f} of the bound), "
              f"{r['off_rounded_share']:.3g} off; changed "
              f"{r['changed_share']:.4f} of them, {r['update_kept']:.4f} of "
              f"the float64 update's norm kept", flush=True)
    if any(r["mu_rel_err"] > UPDATE_MOMENT_RTOL
           or r["nu_rel_err"] > UPDATE_MOMENT_RTOL
           or r["err_over_bound"] > 1
           or r["off_rounded_share"] > UPDATE_OFF_SHARE
           for r in update.values()):
        fail(f"{TRAIN_ARCH}: the bf16 update is off float64 AdamW: {update}")
    # where one step's time goes: three more steps (warm-up, timed, traced)
    state = {"params": params, "opt": opt,
             "batch": make_global_batch(data, TRAIN_STEPS, device="cuda")}
    opt = None            # the state holds the moments: one copy, not two

    def one_more():
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], state["batch"])
    split = time_split(one_more, reps=1, top=8)
    params, opt = state["params"], state["opt"]
    a["step_split"] = split
    print_split(TRAIN_ARCH, "train step (8 x 1024 tokens, accum 2)", split)
    print(f"{TRAIN_ARCH} train step, top kernels (device ms): " + ", ".join(
        f"{k['kernel'][:70]} {k['ms']:.2f}" for k in split["top_kernels"]),
        flush=True)

    # ---- (b) the train step's hotspots -------------------------------------
    t = time.perf_counter()
    batch = make_global_batch(data, TRAIN_STEPS + 3, device="cuda")
    spots = extraction.profile_all(step_fn, params, opt, batch)
    torch.cuda.synchronize()
    prof_s = time.perf_counter() - t
    attention = [(i + 1, s) for i, s in enumerate(spots)
                 if s.family == "attention"]
    total = sum(s.flops for s in spots)
    print(f"{TRAIN_ARCH}: hotspots of one train step (step {TRAIN_STEPS + 3}, "
          f"run under the extraction's modes in {prof_s:.2f} s), "
          f"{len(spots)} products, {total:.4g} FLOPs ("
          f"{total / (6 * n_params * tokens):.3f} x 6·N·tokens):\n"
          + extraction.report(spots[:10]), flush=True)
    print(f"{TRAIN_ARCH}: attention hotspots (rank of {len(spots)}): "
          + "; ".join(f"#{r} {s.flops:.3e} {s.source}"
                      f"{' (backward)' if s.backward else ''} -> "
                      f"'{s.suggested_site}'" for r, s in attention),
          flush=True)
    out["hotspots"] = {
        "seconds": prof_s, "products": len(spots), "flops": total,
        "top": [{"primitive": s.primitive, "flops": s.flops,
                 "shapes": s.shapes, "source": s.source, "count": s.count,
                 "family": s.family, "suggested_site": s.suggested_site,
                 "backward": s.backward} for s in spots[:10]],
        "attention": [{"rank": r, "flops": s.flops, "source": s.source,
                       "backward": s.backward,
                       "suggested_site": s.suggested_site}
                      for r, s in attention]}
    if spots[0].primitive not in extraction.PRODUCTS:
        fail(f"{TRAIN_ARCH}: the top hotspot is not a product: {spots[0]}")
    if not any(s.suggested_site == "attention" for _, s in attention):
        fail(f"{TRAIN_ARCH}: no attention hotspot names the splice point "
             f"'attention'")
    del batch, spots

    # ---- (d) a train step through K2 is refused ------------------------------
    zero_launches(flash)
    before = params["layers.0.wq"][:4].clone()
    with ops.use_impl("attention", flash):
        try:
            step_fn(params, opt, make_global_batch(data, 0, device="cuda"))
        except NoBackwardKernelError as e:
            refusal = str(e)
        else:
            fail(f"{TRAIN_ARCH}: a train step with K2 at 'attention' trained")
    if flash.launches or not torch.equal(params["layers.0.wq"][:4], before) \
            or any(p.requires_grad for p in params.values()):
        fail(f"{TRAIN_ARCH}: the refused step launched K2 "
             f"({flash.launches}) or changed the model")
    out["refusal"] = refusal
    print(f"{TRAIN_ARCH}: a train step with K2 at 'attention' raised "
          f"NoBackwardKernelError before any launch: {refusal}", flush=True)
    opt = step_fn = None
    free_card()

    # ---- (c) the trained weights served through K2 ---------------------------
    rec = FirstCalls(flash)
    ops.install("attention", rec, kernel="flash_attention", route="cuda")
    zero_launches(flash)
    lengths = (32, 64, 100, 128)
    rows = data.batch(1000)["tokens"]
    prompts = [rows[i, :n] for i, n in enumerate(lengths)]
    srv = timed_server(BatchedServer(model, slots=4, max_len=256, aot=False))
    t = time.perf_counter()
    served = serve_wave(srv, prompts)
    wall = time.perf_counter() - t
    launches, by_path = flash.launches, dict(flash.launches_by_path)
    need = cfg.n_layers * srv.stats["prefill_calls"]
    print(f"{TRAIN_ARCH}: the trained weights served by an eager "
          f"BatchedServer with K2 at 'attention' ({len(prompts)} requests of "
          f"the training stream, prompt lengths {list(lengths)}, "
          f"{SERVE_MAX_NEW} new tokens) in {wall:.2f} s: "
          f"{srv.stats['prefill_calls']} prefills, K2 launched {launches} "
          f"times ({need} needed), by body {by_path}; decode "
          f"{len(prompts) * (SERVE_MAX_NEW - 1) / srv.stats['decode_s']:.1f}"
          f" tokens/s", flush=True)
    if need == 0 or launches != need:
        fail(f"{TRAIN_ARCH}: K2 launches {launches}, {need} expected")
    if by_path["simt"] or cfg.resolved_head_dim != 80:
        fail(f"{TRAIN_ARCH}: bf16 hd 80 K2 launches off the tensor cores: "
             f"{by_path}")
    checks = zoo_k2_checks(f"trained {TRAIN_ARCH}", rec.calls)
    ops.clear_all()
    probe = torch.as_tensor(rows[0, :256], device="cuda")[None].long()
    lk, _ = prefill_with(model, probe, {"attention": flash})
    plain_logits, _ = prefill_with(model, probe, {"attention": None})
    rel = rel_err(lk, plain_logits)
    agree = sum(int(tok[0] == rows[i, n])
                for i, (n, tok) in enumerate(zip(lengths, served)))
    out["serve"] = {"prompt_lengths": list(lengths), "wall_s": wall,
                    "prefill_calls": srv.stats["prefill_calls"],
                    "k2_launches": launches, "k2_launches_by_path": by_path,
                    "logits_rel_err": rel, "tokens": served,
                    "first_token_is_the_streams_next": agree}
    print(f"{TRAIN_ARCH}: trained weights, last-token prefill logits (S 256)"
          f" through K2 against the plain version: max rel err {rel:.3g} "
          f"(tol {LOGITS_RTOL}); the first served token is the stream's next"
          f" token in {agree}/{len(prompts)} requests", flush=True)
    if not (torch.isfinite(lk).all() and rel <= LOGITS_RTOL):
        fail(f"{TRAIN_ARCH}: trained logits through K2 off the plain "
             f"version: {rel}")
    params = None
    del model, srv, rec
    free_card()

    # ---- (e) the fault-tolerant loop on device tensors -----------------------
    small = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                                param_dtype="float32")
    seed_model = get_model(small, device="cpu")
    seed_model.init_params(torch.Generator().manual_seed(0))
    state_dict = {k: v.clone() for k, v in seed_model.state_dict().items()}
    small_data = SyntheticLMData(small, 64, 4, seed=3)
    small_opt = AdamWConfig(lr=1e-3)
    with tempfile.TemporaryDirectory() as tmp:
        p1, r1, f1 = ft_run(f"{tmp}/a", small, state_dict, small_data,
                            small_opt, {6: 1})
        p2, r2, f2 = ft_run(f"{tmp}/b", small, state_dict, small_data,
                            small_opt, {})
    ft_err = max(float((p1[n] - p2[n]).abs().max()) for n in p1)
    out["fault_tolerance"] = {"restarts": [r1, r2], "final_step": [f1, f2],
                              "max_abs_diff": ft_err}
    print(f"fault-tolerant loop on the card ({small.name}, f32, checkpoint "
          f"every 4 steps, 10 steps): a failure injected at step 6 "
          f"({r1} restart) ends at the uninterrupted run's parameters, max "
          f"abs diff {ft_err:.3g} (tol 1e-6)", flush=True)
    if (r1, r2, f1, f2) != (1, 0, 10, 10) or ft_err > 1e-6:
        fail(f"fault-tolerant loop: restarts {r1}/{r2}, steps {f1}/{f2}, "
             f"diff {ft_err}")

    # ---- (f) the same two train steps on the card and on the CPU -----------
    runs = {}
    for dev in ("cpu", "cuda"):
        m = get_model(small, device=dev)
        m.load_state_dict(state_dict)
        first_grads = {}
        runs[dev] = (first_grads, *train_steps_here(
            m, small_opt, small_data, 2, dev, record=first_grads))
    (g0, p0, o0, m0), (g1, p1, o1, m1) = runs["cpu"], runs["cuda"]
    top = max(float(t.abs().max()) for t in g0.values())
    grad_ratio = max(float(((g1[n].cpu() - g0[n]).abs()
                            / (TRAIN_GRAD_TOL[0] * g0[n].abs()
                               + TRAIN_GRAD_TOL[1] * top)).max()) for n in g0)
    metric_err = max(abs(b[k] - a[k]) / abs(a[k]) for a, b in zip(m0, m1)
                     for k in ("loss", "grad_norm", "lr"))
    moment_ratio = max(
        float((o1[key][n].cpu() - o0[key][n]).abs().max())
        / (TRAIN_MOMENT_TOL * max(float(t.abs().max())
                                  for t in o0[key].values()))
        for key in ("mu", "nu") for n in o0[key])
    out["card_vs_cpu"] = {"grad_tol_ratio": grad_ratio,
                          "metric_rel_err": metric_err,
                          "moment_tol_ratio": moment_ratio,
                          "losses": [[r["loss"] for r in m0],
                                     [r["loss"] for r in m1]]}
    print(f"train steps of {small.name} (f32, TF32 off) on the card against "
          f"the CPU: first-step gradients at {grad_ratio:.3f} of their gate "
          f"(rtol {TRAIN_GRAD_TOL[0]}, {TRAIN_GRAD_TOL[1]} of the largest), "
          f"loss/grad norm/lr max rel err {metric_err:.3g} (tol "
          f"{TRAIN_METRIC_RTOL}), moments at {moment_ratio:.3f} of theirs "
          f"({TRAIN_MOMENT_TOL} of the largest)", flush=True)
    if grad_ratio > 1 or metric_err > TRAIN_METRIC_RTOL or moment_ratio > 1:
        fail("train steps on the card disagree with the CPU's")

    out["seconds"] = time.perf_counter() - t0
    print(f"phase 19 (training) took {out['seconds']:.1f} s", flush=True)
    free_card()
    return {"total": launches, **by_path}, checks


# --------------------------------------------------------------------------
# the campaign fabric on the card (phase 20): worker processes under one
# device lease
# --------------------------------------------------------------------------
FABRIC_CASES = ("gemm", "2mm", "syrk")
FABRIC_DIR = OUT.parent / "fabric"
# memory after a worker was killed and replaced, against before the kill;
# a worker's CUDA context alone is ~0.5 GiB, so a context that did not go
# back to the card reads twice this
FABRIC_MEM_TOL = 256 * 2**20
# each worker or server process closed must give the card back at least
# this (its CUDA context alone is more), read just before and after the
# close, with no device work here between
FABRIC_PROCESS_MIN = 256 * 2**20
# a stalled job's budget: the worker sleeps STALL_S, the executor waits
# STALL_TIMEOUT_S before it replaces the worker
STALL_TIMEOUT_S, STALL_S = 4.0, 60.0
# the interference control's window: calls back to back between two
# events, ~13 ms quiet, so it spans several of the card's time slices
WINDOW_CALLS = 100
# the interference control's second context: K1 at 4096^3 f32 in a loop
# (~8 ms a launch), until told to stop or this many seconds have passed
INTERFERER = """
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.measure import card_key, get_device_lease
from repro_torch.kernels.matmul import matmul
# start-up under the card's lease: it must not land in a worker's timing
with get_device_lease(card_key("cuda"), device="cuda").hold("control"):
    a = torch.randn(4096, 4096, device="cuda")
    b = torch.randn(4096, 4096, device="cuda")
    matmul(a, b)
print("READY", flush=True)
if sys.stdin.readline().strip() != "GO":
    sys.exit(0)
print("LOOPING", flush=True)
end = time.monotonic() + float(sys.argv[2])
while time.monotonic() < end:
    for _ in range(4):
        matmul(a, b)
    torch.cuda.synchronize()
"""


def fabric_lines(path):
    """The launch log's lines (one a worker job)."""
    if not path.exists():
        return []
    return [json.loads(ln) for ln in path.read_text().splitlines()
            if ln.strip()]


def fabric_k1_call(sig, seed=0):
    """A K1 call a worker reported (shapes, strides, dtypes, keywords) as
    arguments on the card: each operand from ``datagen`` (normal, seed
    ``seed``), laid out with the reported strides."""
    import torch
    from repro_torch.core import datagen
    from repro_torch.core.kernelcase import ArraySpec
    args = []
    for i, a in enumerate(sig["args"]):
        if not isinstance(a, dict):
            args.append(a)
            continue
        n = 1 + sum((d - 1) * st for d, st in zip(a["shape"], a["stride"]))
        (base,) = datagen.generate([ArraySpec((n,), "float32")], seed + i)
        flat = torch.from_numpy(base).to("cuda", getattr(torch, a["dtype"]))
        args.append(torch.as_strided(flat, a["shape"], a["stride"]))
    while args and args[-1] is None:
        args.pop()
    return tuple(args), dict(sig["kw"])


def k1_expected_path(args, kw):
    """The body K1 must take for a call (``matmul.path_for``)."""
    from repro_torch.kernels.matmul import fit, path_for
    a, b = args[:2]
    M, K = a.shape
    N = b.shape[1]
    return path_for(a.dtype, fit(kw.get("block_m", 128), M),
                    fit(kw.get("block_n", 128), N),
                    fit(kw.get("block_k", 128), K),
                    (*a.stride(), *b.stride()),
                    (a.data_ptr(), b.data_ptr()))


def lease_holds(db, campaign=None):
    """The device-lease holds a ResultsDB journaled (optionally of one
    campaign), in start order, and whether any two overlapped."""
    holds = sorted((r for r in db.records("device_lease")
                    if campaign is None or r.get("campaign") == campaign),
                   key=lambda r: r["t0"])
    overlaps = [(a["pid"], b["pid"]) for a, b in zip(holds, holds[1:])
                if b["t0"] < a["t1"]]
    return holds, overlaps


def summarize_holds(holds):
    """Per worker (pid, host alias): holds, held and waited seconds."""
    out = {}
    for h in holds:
        s = out.setdefault(f"{h['pid']}@{h['host']}", {
            "holds": 0, "held_s": 0.0, "wait_s": 0.0, "what": {}})
        s["holds"] += 1
        s["held_s"] += h["t1"] - h["t0"]
        s["wait_s"] += h["t0"] - h["t_req"]
        s["what"][h["what"]] = s["what"].get(h["what"], 0) + 1
    return out


def case_row(res):
    cands = [c for rl in res.rounds for c in rl.candidates]
    ci = [c.ci_half_width_s for c in cands if c.status == "ok"
          and c.variant == res.best_variant and not c.cached]
    return {"case": res.case_name, "scale": mep_scale(res.mep_log),
            "best_variant": res.best_variant, "speedup": res.speedup,
            "baseline_ms": res.baseline_time_s * 1e3,
            "best_ms": res.best_time_s * 1e3,
            "best_ci_ms": ci[0] * 1e3 if ci else 0.0,
            "fe_checked": len(cands),
            "ok": sum(c.status == "ok" for c in cands),
            "fe_fail": sum(c.status == "fe_fail" for c in cands),
            "aer_repairs": res.aer_records,
            "cache_hits": res.cache_hits, "cache_misses": res.cache_misses}


def fabric_launch_totals(lines):
    """K1 launches of the given log lines: total and by body, and by the
    device-lease hold they fell in (``outside``: in none)."""
    total = {"total": 0, "mma": 0, "simt": 0}
    by_hold = {}
    for ln in lines:
        for key, n in ln["launches"].get("matmul", {}).items():
            total[key] = total.get(key, 0) + n
        for what, counts in ln.get("launches_by_hold", {}).items():
            by_hold[what] = by_hold.get(what, 0) + counts.get("matmul", 0)
    by_hold["outside"] = total["total"] - sum(by_hold.values())
    return total, by_hold


def interference_control(case, variant, scale, child):
    """gemm's winner through K1 in this process, 5 rounds quiet, then 5
    while ``child`` (another process, its own CUDA context) launches K1 in
    a loop.  Each round reads two ways: the median of RETIME_REPS reps,
    each one call between CUDA events on an idle stream (as the measured
    platforms time a rep), and the mean call of one window of WINDOW_CALLS
    calls back to back between two events (``cuda_ms``).  Returns
    {"rep": (quiet, loaded), "window": (quiet, loaded)}, ms a call."""
    import torch
    from repro_torch.core import datagen
    from repro_torch.core.fe import as_tensors
    inputs = as_tensors(datagen.generate(case.input_specs(scale), 0), "cuda")
    fn = case.build(variant, impl="cuda")

    def rounds():
        rep, window = [], []
        for _ in range(RETIME_ROUNDS):
            rep.append(float(np.median(call_times_ms(fn, inputs,
                                                     RETIME_REPS))))
            window.append(cuda_ms(lambda: fn(*inputs), reps=WINDOW_CALLS,
                                  warmup=1))
        return rep, window

    with torch.no_grad():
        fn(*inputs)
        quiet = rounds()
        child.stdin.write("GO\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "LOOPING":
            fail("the interference control's second process did not start "
                 "its loop")
        time.sleep(0.5)
        loaded = rounds()
    return {"rep": (quiet[0], loaded[0]), "window": (quiet[1], loaded[1])}


def fabric_against_here(ex, platform, case, scale, cfg):
    """The case's baseline timed by eq. 3 (the campaign's R and k, the
    adaptive engine) in a worker of ``ex`` (a job of no rounds, with no
    cache) and in this process under the card's lease, alternating
    RETIME_ROUNDS rounds: both sides' readings (ms), their medians and
    whether the medians agree within the larger of their ranges."""
    from repro_torch.core import CaseJob, HeuristicProposer, MeasureConfig
    from repro_torch.core import datagen
    from repro_torch.core.measure import device_work
    from repro_torch.core.workers import WorkerContext
    import dataclasses
    job = CaseJob(case, HeuristicProposer(0, platform=platform.name),
                  cfg=dataclasses.replace(cfg, d_rounds=0))
    ctx = WorkerContext(platform=platform)
    inputs = datagen.generate(case.input_specs(scale), 0)
    base = dict(case.baseline_variant)
    worker, here = [], []
    for i in range(RETIME_ROUNDS):
        (res,) = ex.run([job], ctx, campaign_id=f"eq3-{i}")
        if not hasattr(res, "baseline_time_s") \
                or mep_scale(res.mep_log) != scale:
            fail(f"the worker's eq. 3 job failed or sized its MEP off "
                 f"scale {scale}: {res}")
        worker.append(res.baseline_time_s * 1e3)
        with device_work(platform, "time"):
            t = platform.time_variant(case, base, scale, inputs, r=cfg.r,
                                      k=cfg.k, budget=MeasureConfig())
        here.append(t.trimmed_mean_s * 1e3)
    spread = max(max(worker) - min(worker), max(here) - min(here))
    mw, mh = float(np.median(worker)), float(np.median(here))
    return {"worker_ms": worker, "here_ms": here, "worker_median": mw,
            "here_median": mh, "spread": spread,
            "agree": abs(mw - mh) <= spread}


def stop_child(child):
    try:
        child.kill()
        child.wait(timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        pass


def wait_exit(pids, timeout_s=30.0):
    """Wait until none of ``pids`` is a live process (reaped or gone)."""
    import os
    deadline = time.monotonic() + timeout_s
    for pid in pids:
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.05)


def close_and_measure(executor, pids):
    """Close ``executor`` (its processes ``pids``) and read the card's free
    memory just before and after, once every process has exited."""
    before = free_bytes()
    executor.close()
    wait_exit(pids)
    deadline = time.monotonic() + 5.0     # the memory comes back soon after
    while True:
        after = free_bytes()
        if after - before >= len(pids) * FABRIC_PROCESS_MIN \
                or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    return {"processes": len(pids), "free_before": before,
            "free_after": after, "returned": after - before}


def free_bytes():
    """The card's free bytes, this process's cached blocks handed back
    first: what other processes hold is what moves it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def phase_fabric(report):
    """Phase 20: the campaign fabric on the card.  (a) A Campaign on h100
    over gemm, 2mm and syrk (K1) on a LocalClusterExecutor of two worker
    processes, at phase 5's D, N, R, k with PPI record-only, with a
    file-backed eval cache and pattern store; K1 launched only in the workers (each worker's launches
    and calls come back through its launch log, outside the wire), then
    held against its plain version here at every call they reported, on
    ``datagen`` inputs; the winners against phase 5's; then the same
    campaign again on the same cache.  (b) Eq. 3 in a worker against eq.
    3 here (alternated), the device-lease holds of (a) (no two overlap)
    and the interference control.  (c) Faults: a worker crash retried on a
    replacement, the card's memory back, and a stalled job a timeout.
    (d) A RemoteExecutor over two spawned loopback hosts under distinct
    aliases, both on the card's one device lease."""
    import os
    import shutil
    from repro_torch.core import (Campaign, CaseJob, EvalCache,
                                  H100Platform, HeuristicProposer,
                                  LocalClusterExecutor, OptConfig,
                                  OptResult, PatternStore, RemoteExecutor,
                                  ResultsDB, WorkerFault, get_case)
    from repro_torch.core.measure import card_key, device_lease_path
    from repro_torch.core.workers import LAUNCH_LOG_ENV
    from repro_torch.kernels.matmul import matmul, matmul_ref

    import threading
    t_phase = time.perf_counter()
    out = report["fabric"] = {}
    shutil.rmtree(FABRIC_DIR, ignore_errors=True)
    FABRIC_DIR.mkdir(parents=True)
    log_path = FABRIC_DIR / "launches.jsonl"
    os.environ[LAUNCH_LOG_ENV] = str(log_path)
    free0 = free_bytes()
    platform = H100Platform()
    card = card_key("cuda")
    print(f"fabric on {platform.name}: the card's device lease "
          f"{device_lease_path(card)}", flush=True)
    # every process the phase needs starts now, side by side: the two
    # workers of (a), the control's second context of (b) and the two
    # fleet servers of (d); none touches the card before its turn but
    # under the lease
    child = subprocess.Popen(
        [sys.executable, "-c", INTERFERER, str(ROOT / "src"), "60"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    ex = LocalClusterExecutor(2)
    rex = RemoteExecutor([{"name": "fabricA"}, {"name": "fabricB"}])
    t_start = time.perf_counter()
    ex._start_all([0, 1])
    fleet_ready = []

    def start_fleet():
        rex._start_all(rex._all_slots())
        fleet_ready.append(time.perf_counter() - t_start)
    fleet_up = threading.Thread(target=start_fleet, daemon=True)
    fleet_up.start()
    # PPI record-only (the reference chaos harness's setting): a case's
    # winner must not depend on which concurrent case recorded first, so
    # the replay below is exact; D, N, R, k as phase 5
    cfg = OptConfig(ppi=False)
    procs = []
    try:
        # ---- (a) the local cluster ---------------------------------------
        ex.warm(timeout_s=120)
        warm_s = time.perf_counter() - t_start
        out["worker_start_s"] = warm_s
        print(f"(a) two workers started and answered a ping in "
              f"{warm_s:.1f} s (pids "
              f"{sorted(w.proc.pid for w in ex._procs.values())}; "
              f"started beside the control's process and the two fleet "
              f"servers)", flush=True)
        cache = EvalCache(str(FABRIC_DIR / "evalcache.jsonl"))
        store = PatternStore(str(FABRIC_DIR / "patterns.jsonl"))
        db = ResultsDB(str(FABRIC_DIR / "campaign_fabric.jsonl"))
        camp = Campaign(platform, patterns=store, cache=cache, db=db,
                        executor=ex)

        def jobs():
            return [CaseJob(get_case(n), HeuristicProposer(
                0, platform=platform.name), cfg=cfg)
                for n in FABRIC_CASES]

        before = matmul.launches
        t = time.perf_counter()
        results = camp.run(jobs())
        out["campaign_s"] = time.perf_counter() - t
        if matmul.launches != before:
            fail(f"the scheduler launched K1 {matmul.launches - before} "
                 "times during the fabric's campaign")
        lines = fabric_lines(log_path)
        cid = next(db.records("campaign_start"))["id"]
        rows = []
        for res in results:
            if not isinstance(res, OptResult):
                fail(f"fabric job failed: {res}")
            row = case_row(res)
            mine = [ln for ln in lines if ln["case"] == res.case_name
                    and ln["campaign"] == cid]
            row["launches"], row["launches_by_hold"] = \
                fabric_launch_totals(mine)
            row["workers"] = sorted({ln["pid"] for ln in mine})
            rows.append(row)
            print(f"  {res.case_name:5s} MEP scale {row['scale']}: "
                  f"{row['baseline_ms']:.4f} ms -> {row['best_ms']:.4f} ms "
                  f"({row['speedup']:.3f}x, {row['best_variant']}); "
                  f"{row['fe_checked']} FE-checked ({row['ok']} ok, "
                  f"{row['fe_fail']} FE fails), AER repairs "
                  f"{row['aer_repairs']}; K1 launches {row['launches']} "
                  f"in worker {row['workers']}, by hold "
                  f"{row['launches_by_hold']}", flush=True)
            if row["launches"]["total"] == 0 or row["ok"] == 0:
                fail(f"{res.case_name}: no K1 launch in a worker or no ok "
                     f"candidate: {row}")
            if row["launches_by_hold"]["outside"]:
                fail(f"{res.case_name}: K1 launched outside the device "
                     f"lease: {row['launches_by_hold']}")
        workers = {}
        for ln in lines:
            w = workers.setdefault(str(ln["pid"]), {"jobs": [],
                                                    "seconds": 0.0})
            w["jobs"].append(ln["case"])
            w["seconds"] += ln["seconds"]
        print(f"  workers: " + "; ".join(
            f"pid {p}: {w['jobs']} in {w['seconds']:.2f} s"
            for p, w in workers.items()) + f"; campaign "
            f"{out['campaign_s']:.1f} s", flush=True)
        out.update(cases=rows, workers=workers)

        # K1 against its plain version at every call the workers reported
        sigs = {}
        for ln in lines:
            for sig in ln["calls"].get("matmul", []):
                args, kw = fabric_k1_call(sig)
                sigs.setdefault(k1_key(*args, **kw), (args, kw))
        checks = []
        for key, (args, kw) in sorted(sigs.items(), key=lambda kv: str(
                kv[0])):
            r = compare_k1(key, args, kw, timed=False)
            r["key"] = list(key)
            want = k1_expected_path(args, kw)
            checks.append(r)
            if not agrees(r) or r["path"] != want:
                fail(f"K1 at a worker's call {key}: {r} (body must be "
                     f"{want})")
        k1_bodies = {b: sum(r["path"] == b for r in checks)
                     for b in ("mma", "simt")}
        print(f"  K1 vs plain here at the workers' {len(checks)} calls "
              f"(datagen inputs, seed 0): largest error of the gate "
              f"{max(r['tol_ratio'] for r in checks):.3f}; bodies "
              f"{k1_bodies}", flush=True)
        if any(r["path"] != "mma" for r in checks
               if all(t % 16 == 0 for t in r["tile"])):
            fail("a worker's K1 call on a tile in multiples of 16 took the "
                 "CUDA cores")
        out["k1_checks"] = checks

        # the winners against phase 5's, re-timed in alternated rounds
        p5 = {r["case"]: r for r in report["campaign"]["cases"]}
        for row in rows:
            ref = p5[row["case"]]
            if row["scale"] != ref["scale"]:
                fail(f"{row['case']}: MEP scale {row['scale']} against "
                     f"phase 5's {ref['scale']}")
            case = get_case(row["case"])
            builds = {"phase 5": case.build(ref["best_variant"],
                                            impl="cuda")}
            if row["best_variant"] != ref["best_variant"]:
                builds["phase 20"] = case.build(row["best_variant"],
                                                impl="cuda")
            _, rounds = alternate_builds(case, ref["scale"], builds)
            spread = {k: max(v) - min(v) for k, v in rounds.items()}
            med = {k: float(np.median(v)) for k, v in rounds.items()}
            same = "phase 20" not in builds
            agree = same or abs(med["phase 5"] - med["phase 20"]) \
                <= max(spread.values())
            row.update(phase5_variant=ref["best_variant"],
                       phase5_best_ms=ref["best_ms"],
                       phase5_best_ci_ms=ref.get("best_ci_ms", 0.0),
                       retimed=rounds, winner_agrees=agree,
                       best_over_phase5=row["best_ms"] / ref["best_ms"])
            print(f"  {row['case']:5s} winner "
                  + ("= phase 5's" if same else
                     f"{row['best_variant']} vs phase 5's "
                     f"{ref['best_variant']}")
                  + "; re-timed medians " + ", ".join(
                      f"{k} {med[k]:.4f} ms (spread {spread[k]:.4f})"
                      for k in rounds)
                  + f"; fabric best {row['best_ms']:.4f} ms (CI "
                  f"{row['best_ci_ms']:.4f}) against phase 5's "
                  f"{ref['best_ms']:.4f} (CI {ref.get('best_ci_ms', 0):.4f})"
                  f", {row['best_over_phase5']:.3f}x (minutes apart: not "
                  f"gated; the alternated eq. 3 comparison below is)",
                  flush=True)
            if not agree:
                fail(f"{row['case']}: the fabric's winner and phase 5's "
                     "differ beyond their spread")

        # the same campaign again on the same cache
        t = time.perf_counter()
        again = camp.run(jobs())
        replay_s = time.perf_counter() - t
        cid2 = list(db.records("campaign_start"))[-1]["id"]
        replay_lines = [ln for ln in fabric_lines(log_path)
                        if ln["campaign"] == cid2]
        total, by_hold = fabric_launch_totals(replay_lines)
        holds2, _ = lease_holds(db, cid2)
        what2 = sorted({h["what"] for h in holds2})
        misses = sum(r.cache_misses for r in again)
        winners_same = all(a.best_variant == b.best_variant
                           and a.best_time_s == b.best_time_s
                           for a, b in zip(results, again))
        evaluated = sum(n for what, n in by_hold.items()
                        if what != "probe")
        out["replay"] = {"seconds": replay_s, "cache_misses": misses,
                         "cache_hits": sum(r.cache_hits for r in again),
                         "k1_launches": total, "by_hold": by_hold,
                         "holds": what2, "winners_same": winners_same,
                         "k1_launches_evaluating": evaluated}
        print(f"  replay on the same cache: {replay_s:.1f} s, cache hits "
              f"{out['replay']['cache_hits']}, misses {misses}; K1 "
              f"launches in the workers' FE and timing {evaluated}; in "
              f"MEP sizing probes {by_hold.get('probe', 0)} (the probe memo "
              f"is a worker's own: a case that lands on the other worker "
              f"is probed again); lease holds {what2}; winners equal: "
              f"{winners_same}", flush=True)
        if misses or not winners_same or evaluated:
            fail("the replay re-evaluated or launched K1 outside MEP "
                 f"sizing: {out['replay']}")

        # ---- (b) interference, and the lease that prevents it -----------
        # eq. 3 in a worker against eq. 3 here, alternated (readings taken
        # minutes apart drift by more than a CI on this card): gemm's
        # baseline at phase 5's scale, timed by a worker's job (no cache:
        # measured afresh) and by this process, under the card's lease
        ab = fabric_against_here(ex, platform, get_case("gemm"),
                                 rows[0]["scale"], cfg)
        out["eq3_against_here"] = ab
        print(f"(b) eq. 3 of gemm's baseline (R 30 k 3, scale "
              f"{rows[0]['scale']}), 5 alternated rounds: in a worker "
              + ", ".join(f"{t:.4f}" for t in ab["worker_ms"])
              + " ms; here " + ", ".join(f"{t:.4f}" for t in ab["here_ms"])
              + f" ms: medians {ab['worker_median']:.4f} and "
              f"{ab['here_median']:.4f}, within the larger spread "
              f"{ab['spread']:.4f}: {ab['agree']}", flush=True)
        if not ab["agree"]:
            fail(f"eq. 3 in a worker reads unlike eq. 3 here: {ab}")
        holds, overlaps = lease_holds(db, cid)
        per = summarize_holds(holds)
        out["lease"] = {"card": card, "holds": len(holds),
                        "overlaps": overlaps, "workers": per}
        print(f"(b) device-lease holds of (a): {len(holds)} by "
              f"{len(per)} workers, overlapping pairs {len(overlaps)}; "
              + "; ".join(f"{w}: {s['holds']} holds {s['what']}, held "
                          f"{s['held_s']:.2f} s, waited {s['wait_s']:.2f} s"
                          for w, s in per.items()), flush=True)
        if overlaps or len(per) < 2:
            fail(f"device-lease holds overlap or come from one worker: "
                 f"{out['lease']}")
        if child.stdout.readline().strip() != "READY":
            fail("the interference control's second process did not start")
        gemm = rows[0]
        control = interference_control(
            get_case("gemm"), gemm["best_variant"], gemm["scale"], child)
        stop_child(child)
        out["interference"] = {}
        for how, (quiet, loaded) in control.items():
            spread = max(quiet) - min(quiet)
            out["interference"][how] = {
                "quiet_ms": quiet, "loaded_ms": loaded,
                "above": min(loaded) > max(quiet) + spread,
                "below": max(loaded) < min(quiet) - spread}
            calls = WINDOW_CALLS if how == "window" else RETIME_REPS
            print(f"  interference control, {how} (gemm's winner through "
                  f"K1 here, 5 rounds of {calls} calls): quiet "
                  f"{float(np.median(quiet)):.4f} ms a call (rounds "
                  f"{min(quiet):.4f}-{max(quiet):.4f}), while a second "
                  f"process launches K1 in a loop "
                  f"{float(np.median(loaded)):.4f} (rounds "
                  f"{min(loaded):.4f}-{max(loaded):.4f})", flush=True)
        # a window of calls spans the card's time slices: the other
        # context's launches land inside it; a one-call rep moves too
        # (either way: it is timed inside one slice or across two)
        w, r = out["interference"]["window"], out["interference"]["rep"]
        if not w["above"] or not (r["above"] or r["below"]):
            fail("the loaded readings do not move beyond the quiet ones' "
                 f"spread: {out['interference']}")

        # ---- (c) faults ------------------------------------------------
        pids = {s: w.proc.pid for s, w in ex._procs.items()}
        free_warm = free_bytes()
        crash = CaseJob(get_case("syrk"), HeuristicProposer(
            0, platform=platform.name), cfg=cfg, label="syrk#crash")
        crash.inject = {"crash_once_flag": str(FABRIC_DIR / "crash.flag")}
        t = time.perf_counter()
        (retried,) = camp.run([crash])
        crash_s = time.perf_counter() - t
        faults = [r for r in db.records("worker_fault")
                  if r["job"] == "syrk#crash"]
        new_pids = {s: w.proc.pid for s, w in ex._procs.items()}
        replaced = sorted(set(new_pids.values()) - set(pids.values()))
        dead = sorted(set(pids.values()) - set(new_pids.values()))
        wait_exit(dead)
        free_after = free_bytes()
        ref = next(r for r in results if r.case_name == "syrk")
        same = retried.best_variant == ref.best_variant \
            and retried.best_time_s == ref.best_time_s
        out["crash"] = {"faults": faults, "replacement_pids": replaced,
                        "killed_pids": dead, "seconds": crash_s,
                        "result_equal": same, "free_warm": free_warm,
                        "free_after": free_after}
        print(f"(c) a crashed worker (pid {dead}) replaced by pid "
              f"{replaced} in {crash_s:.1f} s: {len(faults)} worker_fault "
              f"record(s) ({[f['fault'] for f in faults]}); retried result "
              f"equal to (a)'s: {same}; free memory before the kill "
              f"{free_warm / 2**30:.3f} GiB, after the replacement "
              f"{free_after / 2**30:.3f} GiB (tolerance "
              f"{FABRIC_MEM_TOL / 2**20:.0f} MiB)", flush=True)
        if len(faults) != 1 or faults[0]["fault"] != "crash" \
                or len(replaced) != 1 or not same:
            fail(f"the crash was not retried on a replacement to the same "
                 f"result: {out['crash']}")
        if abs(free_after - free_warm) > FABRIC_MEM_TOL:
            fail("the killed worker's memory did not return to the card")
        stall = CaseJob(get_case("gemm"), HeuristicProposer(
            0, platform=platform.name), cfg=cfg, label="gemm#stall")
        stall.inject = {"sleep_s": STALL_S}
        ex.timeout_s, ex.retries = STALL_TIMEOUT_S, 0
        t = time.perf_counter()
        (stalled,) = ex.run([stall], camp_ctx(camp), campaign_id="stall")
        print(f"  a job stalled {STALL_S:.0f} s under a "
              f"{STALL_TIMEOUT_S:.0f} s budget: {type(stalled).__name__} "
              f"kind {getattr(stalled, 'kind', None)} after "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if not (isinstance(stalled, WorkerFault)
                and stalled.kind == "timeout"):
            fail(f"the stalled job came back as {stalled!r}")
        out["stall"] = {"outcome": type(stalled).__name__,
                        "kind": getattr(stalled, "kind", None)}
        out["cluster_close"] = close_and_measure(
            ex, [w.proc.pid for w in ex._procs.values()])

        # ---- (d) the fleet: two spawned loopback hosts on one card ------
        fleet_db = ResultsDB(str(FABRIC_DIR / "campaign_fleet.jsonl"))
        fleet_cache = EvalCache(str(FABRIC_DIR / "evalcache_fleet.jsonl"))
        fleet_up.join()
        rex.warm(timeout_s=120)
        fleet_start = fleet_ready[0] if fleet_ready else float("nan")
        fcamp = Campaign(platform, cache=fleet_cache, db=fleet_db,
                         executor=rex)
        t = time.perf_counter()
        fres = fcamp.run([CaseJob(get_case("gemm"), HeuristicProposer(
            seed, platform=platform.name), cfg=cfg, seed=seed,
            label=f"gemm#{seed}") for seed in (0, 1)])
        fleet_s = time.perf_counter() - t
        events = rex.fleet_events()
        out["fleet_close"] = close_and_measure(
            rex, [srv.proc.pid for srv in rex._servers.values()])
    finally:
        stop_child(child)
        procs = [w.proc.pid for w in ex._procs.values()] + [
            s.proc.pid for s in rex._servers.values()]
        ex.close()
        fleet_up.join()
        rex.close()
    wait_exit(procs)
    fholds, foverlaps = lease_holds(fleet_db)
    fper = summarize_holds(fholds)
    aliases = {h["host"] for h in fholds}
    cards = {h["card"] for h in fholds}
    ns = {json.loads(ln).get("ns") for ln in
          Path(fleet_cache.path).read_text().splitlines() if ln.strip()}
    hosts = {r.get("host") for r in fleet_db.records("case_result")}
    flines = [ln for ln in fabric_lines(log_path)
              if ln["host"] in ("fabricA", "fabricB")]
    ftotal, fby_hold = fabric_launch_totals(flines)
    out["fleet"] = {"start_s": fleet_start, "seconds": fleet_s,
                    "fleet_events": events, "case_hosts": sorted(hosts),
                    "lease_aliases": sorted(aliases), "cards": sorted(cards),
                    "overlaps": foverlaps, "holds": fper,
                    "namespaces": sorted(n for n in ns if n),
                    "k1_launches": ftotal, "by_hold": fby_hold,
                    "winners": [r.best_variant for r in fres]}
    print(f"(d) RemoteExecutor over spawned loopback hosts fabricA and "
          f"fabricB: both servers READY {fleet_start:.1f} s after the "
          f"phase's processes started, gemm (seeds 0, 1) "
          f"in {fleet_s:.1f} s on hosts {sorted(hosts)}; fleet_events "
          f"{events}; device-lease holds by {sorted(aliases)} on card(s) "
          f"{sorted(cards)}, overlapping pairs {len(foverlaps)}; "
          + "; ".join(f"{w}: {s['holds']} holds, waited {s['wait_s']:.2f} s"
                      for w, s in fper.items())
          + f"; cache namespaces {out['fleet']['namespaces']}; K1 launches "
          f"{ftotal} (by hold {fby_hold})", flush=True)
    if aliases != {"fabricA", "fabricB"} or len(cards) != 1 or foverlaps:
        fail(f"the two hosts did not share the card's one lease: "
             f"{out['fleet']}")
    if not all(any(a in n for n in ns if n) for a in ("fabricA",
                                                        "fabricB")):
        fail(f"the cache records lack an alias's namespace: {ns}")
    if fby_hold["outside"] or not ftotal["total"]:
        fail(f"the fleet's K1 launches: {ftotal}, by hold {fby_hold}")

    os.environ.pop(LAUNCH_LOG_ENV, None)
    out["free_before"], out["free_after"] = free0, free_bytes()
    for what, c in (("the cluster's live workers", out["cluster_close"]),
                    ("the fleet's servers", out["fleet_close"])):
        print(f"  closing {what} ({c['processes']}) gave the card back "
              f"{c['returned'] / 2**20:.0f} MiB (at least "
              f"{FABRIC_PROCESS_MIN / 2**20:.0f} MiB a process)",
              flush=True)
        if c["returned"] < c["processes"] * FABRIC_PROCESS_MIN:
            fail(f"closing {what} did not give the card its memory back: "
                 f"{c}")
    print(f"  free memory {out['free_after'] / 2**30:.3f} GiB at the "
          f"phase's end, {free0 / 2**30:.3f} GiB at its start (this "
          f"process's own modules and cuBLAS state grew between)",
          flush=True)
    all_lines = fabric_lines(log_path)
    out["worker_launches"], _ = fabric_launch_totals(all_lines)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20 wall time: {out['seconds']:.1f} s", flush=True)
    return out["worker_launches"], out["k1_checks"]


def camp_ctx(camp):
    """A campaign's WorkerContext, for running jobs on its executor
    directly."""
    from repro_torch.core.workers import WorkerContext
    return WorkerContext(platform=camp.platform, cache=camp.cache,
                         patterns=camp.patterns, db=camp.db,
                         measure=camp.measure, lease_path=camp.lease_path,
                         lease_scope=camp.lease_scope)


def main() -> None:
    import gc
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
    laps = report["phase_seconds"] = {}

    def lap(name):
        laps[name] = time.perf_counter() - t_start - sum(laps.values())

    name, smi = phase_device(report)
    lap("device and build")
    phase_kernel(report)
    lap("K2")
    glm_launches, glm_calls, glm_checks = phase_serve(report, "glm4-9b")
    gc.collect()
    torch.cuda.empty_cache()
    args, kw = max(glm_calls["flash_attention"].values(), key=lambda c: (
        c[0][0].shape[0] * c[0][0].shape[1] * c[0][1].shape[1]))
    q, k, v = args
    causal = kw.get("causal", True)
    main_shape = compare(q, k, v, causal)
    if not agrees(main_shape):
        fail(f"kernel disagrees at the serving run's shape: {main_shape}")
    require_mma(main_shape, "the main shape")
    main_shape.update(k2_main_shape_times(q, k, v, causal))
    report["main_path_shape"] = main_shape
    lap("glm4-9b")

    k1_launches, k1_calls, main_key = phase_campaign(report)
    k1_rows, k1_main = phase_k1_checks(report, k1_calls, main_key)
    k2_pipeline_checks = phase_integrate(report)
    lap("campaign, K1, integrate")

    phase_recurrent_kernels(report)
    rwkv_launches, rwkv_calls, rwkv_checks = phase_serve(report, "rwkv6-7b")
    gc.collect()
    torch.cuda.empty_cache()
    lap("K6 and K7, rwkv6-7b")
    hymba_launches, hymba_calls, hymba_checks = phase_serve(report,
                                                            "hymba-1.5b")
    gc.collect()
    torch.cuda.empty_cache()
    lap("hymba-1.5b")
    table4_checks = phase_table4(report)
    gc.collect()
    torch.cuda.empty_cache()
    lap("table 4")
    suite_launches, suite_calls, suite_results = phase_suite_kernels(report)
    suite_checks, suite_mains, k5_fixed = phase_suite_kernel_checks(
        report, suite_calls, suite_results)
    lap("suites")
    phase_tables(report)
    lap("tables 1-3")
    pop_launches, pop_checks = phase_population(report)
    gc.collect()
    torch.cuda.empty_cache()
    lap("population")
    phase_online(report)
    lap("online")
    zoo_launches, zoo_by_path, zoo_checks = phase_zoo(report)
    lap("decoder-only zoo")
    whisper_launches, whisper_checks, whisper_times = phase_whisper(report)
    lap("whisper-medium")
    train_launches, train_checks = phase_training(report)
    lap("training")
    fabric_launches, fabric_checks = phase_fabric(report)
    lap("fabric")
    wkv_main, wkv_call = main_recurrent_shape("wkv", rwkv_calls["wkv"])
    wkv_main["host_us_per_call"] = host_us_per_call(
        lambda: kernel_pair("wkv")[0](*wkv_call[0], **wkv_call[1]))
    ssd_main, ssd_call = main_recurrent_shape("ssd", hymba_calls["ssd"])
    ssd_main.update(ssd_main_shape_extras(*ssd_call))
    report["wkv_main_shape"], report["ssd_main_shape"] = wkv_main, ssd_main

    # (label, wrapper, row, call) of each main shape
    timed = [("flash_attention", "flash_attention", main_shape,
              ((q, k, v), {"causal": causal})),
             ("matmul", "matmul", k1_main, k1_calls[main_key]),
             ("wkv", "wkv", wkv_main, wkv_call),
             ("ssd", "ssd", ssd_main, ssd_call),
             *[(n, n, r, call) for n, (r, call) in suite_mains.items()],
             *[(f"grouped_matmul main {d}", "grouped_matmul", r, call)
               for d, (r, call) in k5_fixed.items()],
             *[(f"flash_attention whisper {n}", "flash_attention", r, call)
               for n, (r, call) in whisper_times.items()]]
    for (_, _, r, _), dev in zip(timed, fresh_device_time(
            [(n, *device_time_args(n, call)) for _, n, _, call in timed])):
        r["kernel_device_ms"] = dev["device_ms"]
        r["kernel_trace"] = {key: dev[key]
                             for key in ("traces", "sentinels_lost")}
    print("profiler device ms in a fresh process (CUDA events): "
          + ", ".join(f"{label} {r['kernel_device_ms']:.4f} ({r['ms']:.4f})"
                      for label, _, r, _ in timed), flush=True)
    main_shape["host_bound"] = bool(
        main_shape["ms"] > 1.5 * main_shape["kernel_device_ms"])
    if main_shape["host_bound"]:
        print(f"K2 at the main shape is host-bound: CUDA events "
              f"{main_shape['ms']:.4f} ms against device "
              f"{main_shape['kernel_device_ms']:.4f} ms; the wrapper costs "
              f"{main_shape['host_us_per_call']:.1f} us of host time a call",
              flush=True)
    k2_by_path = {body: sum(report[f"serve_{a}"]["launches_by_path"][
        "flash_attention"][body] for a in ("glm4-9b", "hymba-1.5b"))
        + zoo_by_path[body] + whisper_launches[body] + train_launches[body]
        for body in ("mma", "simt")}

    k7_by_path = {body: report["serve_hymba-1.5b"]["launches_by_path"][
        "ssd"][body] + pop_launches["ssd"][body] for body in ("mma", "simt")}

    def recurrent_entry(name, source, replaces, launches, checks, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": glm_launches["flash_attention"]
        + hymba_launches["flash_attention"] + zoo_launches
        + whisper_launches["total"] + train_launches["total"],
        "launches_by_path": k2_by_path,
        "main_shape_path": main_shape["path"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           glm_checks["flash_attention"] + k2_pipeline_checks
                           + hymba_checks["flash_attention"] + zoo_checks
                           + whisper_checks + train_checks),
        "ms": main_shape["ms"], "device_ms": main_shape["kernel_device_ms"],
        "simt_ms": main_shape["simt_ms"],
        "host_us_per_call": main_shape["host_us_per_call"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "p_bf16_control_tol_ratio": main_shape["p_bf16_control_tol_ratio"],
        **{f"whisper_{n}_shape": {
            key: r[key] for key in ("B", "S", "T", "H", "hd", "path", "ms",
                                    "kernel_device_ms", "simt_ms",
                                    "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "host_us_per_call")}
           for n, (r, _) in whisper_times.items()},
        "whisper_causal_mask_control_tol_ratio": report["whisper"][
            "causal_mask_control_tol_ratio"],
    }, {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/suites/pallas_lib.py:70",
        "launches": k1_launches["total"] + suite_launches["matmul"]
        + pop_launches["matmul"]["total"] + fabric_launches["total"],
        "launches_by_path": {
            path: k1_launches[path] + suite_launches["matmul_by_path"][path]
            + pop_launches["matmul"][path] + fabric_launches[path]
            for path in ("mma", "simt")},
        "launches_in_workers": fabric_launches,
        "main_shape_path": k1_main["path"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           k1_rows + suite_checks["matmul"]
                           + pop_checks["matmul"] + fabric_checks),
        "ms": k1_main["ms"], "device_ms": k1_main["kernel_device_ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"],
        "library_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "tf32_control_tol_ratio": k1_main["tf32_control_tol_ratio"],
    }, *suite_entries(suite_launches, suite_checks, suite_mains, k5_fixed),
        {**recurrent_entry(
            "rwkv_wkv", "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
            "src/repro/kernels/rwkv_wkv.py:65",
            rwkv_launches["wkv"] + pop_launches["wkv"]["total"],
            rwkv_checks["wkv"] + table4_checks["wkv"] + pop_checks["wkv"],
            wkv_main),
         "device_ms": wkv_main["kernel_device_ms"],
         "host_us_per_call": wkv_main["host_us_per_call"]},
        {**recurrent_entry(
            "ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan.py:73",
            hymba_launches["ssd"] + pop_launches["ssd"]["total"],
            hymba_checks["ssd"] + table4_checks["ssd"] + pop_checks["ssd"],
            ssd_main),
         "launches_by_path": k7_by_path,
         "main_shape_path": ssd_main["path"],
         "device_ms": ssd_main["kernel_device_ms"],
         "simt_ms": ssd_main["simt_ms"],
         "host_us_per_call": ssd_main["host_us_per_call"],
         "one_pass_control_tol_ratio": ssd_main[
             "one_pass_control_tol_ratio"],
         "f32_one_pass_control_tol_ratio": ssd_main[
             "f32_one_pass_control_tol_ratio"]}]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(f"flash_attention at the serving run's heaviest shape "
          f"(B={main_shape['B']}, S={main_shape['S']}, {main_shape['dtype']}); "
          f"matmul at gemm's winner {list(main_key)}; wkv and ssd at their "
          f"serving runs' heaviest prefill ({wkv_main['shape']}, "
          f"{ssd_main['shape']}, {wkv_main['dtype']}); reduce_sum and "
          f"elementwise at their cases' winners ("
          + "; ".join(f"{n} {m['key']}" for n, (m, _) in suite_mains.items()
                      if n != "grouped_matmul")
          + "); grouped_matmul at E 8 M 512 K 256 N 512 f32 128^3; "
          f"all phases passed in {report['seconds']:.1f} s; details in "
          f"{OUT.relative_to(ROOT)}", flush=True)
    lap("main shapes")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        laps.items()), flush=True)
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
