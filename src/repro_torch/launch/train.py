"""End-to-end training driver.

Port of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch stablelm-3b --smoke --steps 50

trains a config (``--smoke``: its reduced same-family version in f32) on
one device with the full substrate: the synthetic step-keyed data, AdamW
with clipping, the fault-tolerant checkpoint/restart loop, the straggler
watchdog, and optional int8 error-feedback gradient compression.  It runs
on the card unless ``--device cpu`` is given, and resumes from the latest
checkpoint under ``--ckpt`` (default: ``repro_torch_ckpt`` in the
temporary directory).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.runtime import (FailureInjector, FaultTolerantLoop,
                                 StragglerWatchdog, make_compression_hook)
from repro_torch.train import AdamWConfig, init_state, model_params
from repro_torch.train.steps import make_train_step


def build(arch: str, *, smoke: bool, batch: int, seq: int, lr: float,
          accum: int, compress: bool, seed: int = 0, device="cuda"):
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32")
    model = get_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(seed))
    params = model_params(model)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=100_000)
    opt_state = init_state(params)
    residuals = {"value": None}
    hook = make_compression_hook(residuals) if compress else None
    step_fn = make_train_step(model, opt_cfg, accum=accum, grad_hook=hook)
    data = SyntheticLMData(cfg, seq, batch, seed=seed)
    return cfg, model, params, opt_state, step_fn, data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config in f32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg, model, params, opt_state, step_fn, data = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        lr=args.lr, accum=args.accum, compress=args.compress_grads,
        device=args.device)
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={model.device}")

    manager = CheckpointManager(args.ckpt, keep=2)
    injector = (FailureInjector({args.inject_failure_at: 1})
                if args.inject_failure_at is not None else None)
    loop = FaultTolerantLoop(manager, checkpoint_every=args.checkpoint_every,
                             injector=injector,
                             watchdog=StragglerWatchdog())

    state = {"params": params, "opt": opt_state}
    start = 0
    if manager.latest is not None:
        state, start, _ = manager.restore(state)
        print(f"resumed from step {start}")

    def one_step(state, step):
        batch = make_global_batch(data, step, device=model.device)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    t0 = time.time()
    losses = []

    def logged(state, step):
        state, metrics = one_step(state, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)")
        return state, metrics

    state, final = loop.run(state, logged, start_step=start,
                            num_steps=args.steps)
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"done at step {final}: loss {first:.4f} -> {last:.4f} "
          f"(restarts={loop.restarts}, stragglers={len(loop.watchdog.flagged)})")


if __name__ == "__main__":
    main()
