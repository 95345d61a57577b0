"""Training driver: the port's ``make_train_step`` (AdamW, float32
moments, remat) fed by its ``SyntheticLMData`` pipeline.

Set-up draws the weights from the seed, builds the step and its optimizer
state, and drives that same step through the job's first
``reference_steps`` steps (the autograd and allocator warm-up), recording
each step's loss, each leaf's first gradient as AdamW took it (its first
moment after one step over 1 - b1) and each leaf's change over those
steps.  The window then runs whole steps for ``seconds``, each batch made
by the program's pipeline, and ends at the last step's synchronised end;
a traced run then traces the job's ``trace`` steps more.

After the window (and the traced steps) the state the window left is
kept on the host, and the job's next step runs through the same call and
feed, with the same readings.  The program is then freed, and the float32
reference runs the same first steps from the seed, and that later step
from the kept state (``reference.train``).
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict

import common
from reference import compare
from reference import data as ref_data
from reference import train as ref_train
from reference import weights as W

clock = common.clock


def _leaf_norms(tensors: Dict, scale: float = 1.0) -> Dict[str, float]:
    import torch
    names = list(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names])
    return {n: v * scale for n, v in zip(names, norms.tolist())}


def _changes(params: Dict, model_cfg: Dict, seed: int) -> Dict[str, float]:
    """Each leaf's norm of its change since the seed's weights."""
    import torch
    dev = next(iter(params.values())).device
    start = {f"top.{n}": t for n, t in
             W.top_weights(model_cfg, seed, dev).items()}
    out = {}
    for i in range(model_cfg["n_layers"]):
        start.update({f"layers.{i}.{n}": t for n, t in
                      W.layer_weights(model_cfg, seed, i, dev).items()})
        for n in list(start):
            out[n] = (params[n].float() - start.pop(n).float()).norm()
    names = list(out)
    vals = torch.stack([out[n] for n in names]).tolist()
    return dict(zip(names, vals))


def build(ctx: Dict):
    """(model, step_fn, AdamW config, data pipeline module): the
    configuration's model with the seed's weights and its train step."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import pipeline
    from repro_torch.models import get_model
    from repro_torch.train import optim, steps

    model_cfg, job = ctx["config"]["model"], ctx["traffic"]
    model = get_model(ModelConfig(**model_cfg), device=ctx["device"])
    W.fill(dict(model.named_parameters()), model_cfg, ctx["seed"])
    opt_cfg = optim.AdamWConfig(**job["optimizer"])
    step_fn = steps.make_train_step(model, opt_cfg, accum=job["accum"])
    return model, step_fn, opt_cfg, pipeline


def first_steps(model, step_fn, opt_cfg, pipeline, job: Dict, seed: int,
                dev):
    """Fresh AdamW state and the job's first ``reference_steps`` steps of
    ``step_fn`` on the pipeline's batches.  Returns (params, state, data,
    readings): each step's loss, each leaf's first gradient as AdamW took
    it, each leaf's change, and the batches' tokens."""
    from repro_torch.train import optim, steps
    params = steps.model_params(model)
    state = optim.init_state(params)
    data = pipeline.SyntheticLMData(model.cfg, job["seq_len"],
                                    job["global_batch"], seed=seed)
    losses, batches, first = [], [], None
    for s in range(job["reference_steps"]):
        batch = pipeline.make_global_batch(data, s, device=dev)
        batches.append(batch["tokens"].cpu().numpy())
        params, state, m = step_fn(params, state, batch)
        losses.append(m["loss"])
        if s == 0:
            first = _leaf_norms(state["mu"], 1.0 / (1.0 - opt_cfg.b1))
    readings = {"losses": [float(x) for x in losses], "grad_norms": first,
                "delta_norms": _changes(params, dataclasses.asdict(model.cfg),
                                        seed),
                "batches": batches}
    return params, state, data, readings


def keep(params: Dict, state: Dict) -> Dict:
    """The program's state on the host: each leaf's weights and moments,
    and the step count."""
    import torch
    def host(tree):     # a copy, also of a tensor already on the host
        return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}
    with torch.no_grad():
        return {"params": host(params), "mu": host(state["mu"]),
                "nu": host(state["nu"]), "step": int(state["step"])}


def restore(params: Dict, kept: Dict, dev) -> Dict:
    """Puts the kept weights back into ``params`` in place; returns the
    kept optimizer state on the device."""
    import torch
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(kept["params"][n])
    return {"mu": {n: t.to(dev) for n, t in kept["mu"].items()},
            "nu": {n: t.to(dev) for n, t in kept["nu"].items()},
            "step": torch.tensor(kept["step"], dtype=torch.int32, device=dev)}


def step_readings(params, state, step_fn, opt_cfg, pipeline, data,
                  step: int, kept: Dict, dev) -> Dict:
    """The job's step ``step`` through ``step_fn`` and the pipeline from
    ``state``, which ``kept`` holds on the host: the step's loss, each
    leaf's gradient as AdamW took it ((mu after - b1 mu before) / (1 -
    b1)), each leaf's change over the step, and the batch's tokens."""
    import torch
    batch = pipeline.make_global_batch(data, step, device=dev)
    params, state, m = step_fn(params, state, batch)
    b1 = opt_cfg.b1
    with torch.no_grad():
        names = list(params)
        grads = torch.stack([
            ((state["mu"][n] - b1 * kept["mu"][n].to(dev)) / (1 - b1)).norm()
            for n in names]).tolist()
        moved = torch.stack([
            (params[n].float() - kept["params"][n].to(dev).float()).norm()
            for n in names]).tolist()
    return {"losses": [float(m["loss"])],
            "grad_norms": dict(zip(names, grads)),
            "delta_norms": dict(zip(names, moved)),
            "batches": [batch["tokens"].cpu().numpy()], "first": step}


def late_step(params, state, step_fn, opt_cfg, pipeline, data, step: int,
              dev):
    """The job's step ``step`` from the state given, which is kept on the
    host first.  Returns (kept, ``step_readings``)."""
    kept = keep(params, state)
    return kept, step_readings(params, state, step_fn, opt_cfg, pipeline,
                               data, step, kept, dev)


def gaps(readings: Dict, ref: Dict) -> Dict:
    """The numbers compared, of the program's ``readings`` against the
    reference's (``reference.train.run``)."""
    still = compare.still_leaves(ref["grad_norms"])
    grad, grad_leaf = compare.worst_leaf(readings["grad_norms"],
                                         ref["grad_norms"])
    move, move_leaf = compare.worst_leaf(readings["delta_norms"],
                                         ref["delta_norms"], skip=still)
    return {"loss_gap": max(compare.rel_gap(a, b) for a, b in
                            zip(readings["losses"], ref["losses"])),
            "grad_gap": grad, "grad_leaf": grad_leaf,
            "update_gap": move, "update_leaf": move_leaf,
            "left_out": len(still)}


def rows_off(readings: Dict, model_cfg: Dict, job: Dict, seed: int) -> int:
    """Rows of the program's batches (from step ``first``, 0 if not given)
    that differ from the stream the benchmark draws again
    (``reference.data``)."""
    first = readings.get("first", 0)
    return sum(int((got != ref_data.batch(
        model_cfg["vocab_size"], job["seq_len"], job["global_batch"], seed,
        first + s)[0]).any(axis=1).sum())
        for s, got in enumerate(readings["batches"]))


def run(ctx: Dict) -> Dict:
    import torch

    model_cfg, job = ctx["config"]["model"], ctx["traffic"]
    dev, seed = ctx["device"], ctx["seed"]
    t = clock()
    model, step_fn, opt_cfg, pipeline = build(ctx)
    t_built = clock()
    params, state, data, readings = first_steps(
        model, step_fn, opt_cfg, pipeline, job, seed, dev)
    print(f"set-up: start {t - ctx['t0']:.2f} s, weights {t_built - t:.2f} s,"
          f" first {job['reference_steps']} steps {clock() - t_built:.2f} s",
          flush=True)
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx["before_window"]()
    t_start = clock()
    setup_s = t_start - ctx["t0"]
    step, data_s, losses = job["reference_steps"], [], []
    while clock() < t_start + ctx["seconds"]:
        t = clock()
        batch = pipeline.make_global_batch(data, step, device=dev)
        data_s.append(clock() - t)
        params, state, m = step_fn(params, state, batch)
        losses.append(m["loss"])
        step += 1
    if dev != "cpu":
        torch.cuda.synchronize()
    t_end = clock()
    ctx["after_window"]()
    trace = common.Trace() if ctx["trace"] else None
    if trace is not None:      # after the window: the profiler slows none
        trace.start()          # of the window's steps
        for _ in range(job["trace"]["steps"]):
            with common.span("data", trace):
                batch = pipeline.make_global_batch(data, step, device=dev)
            with common.span("step", trace):
                params, state, m = step_fn(params, state, batch)
            losses.append(m["loss"])
            step += 1
        trace.stop()
    finite = sum(torch.isfinite(torch.stack(losses)).tolist())
    n_steps = len(losses)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    kept, late = late_step(params, state, step_fn, opt_cfg, pipeline, data,
                           step, dev)
    record = {
        "kind": "train", "model": model_cfg, "setup_s": setup_s,
        "t_start": t_start, "t_end": t_end, "window_s": t_end - t_start,
        "steps": len(data_s), "tokens_per_step": job["global_batch"]
        * job["seq_len"], "rows": job["global_batch"], "seq": job["seq_len"],
        "data_s": data_s,
        "trace": trace.result if trace is not None else None,
    }
    del params, state, step_fn, model, m, batch, losses
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    ref = ref_train.run(model_cfg, job, seed, dev, job["reference_steps"])
    g = gaps(readings, ref)
    ref_late = ref_train.resume(model_cfg, job, seed, dev, kept,
                                late["first"])
    del kept
    lg = gaps(late, ref_late)
    lim = ctx["limits"]
    checks = [
        {"name": "data_rows_off", "value": rows_off(readings, model_cfg,
                                                     job, seed)
         + rows_off(late, model_cfg, job, seed),
         "limit": lim["data_rows_off"]},
        {"name": "loss_gap", "value": g["loss_gap"], "limit": lim["loss_gap"],
         "losses": readings["losses"], "reference": ref["losses"]},
        {"name": "grad_gap", "value": g["grad_gap"], "limit": lim["grad_gap"],
         "leaf": g["grad_leaf"]},
        {"name": "update_gap", "value": g["update_gap"],
         "limit": lim["update_gap"], "leaf": g["update_leaf"],
         "left_out": g["left_out"]},
        {"name": "late_loss_gap", "value": lg["loss_gap"],
         "limit": lim["late_loss_gap"], "step": late["first"],
         "loss": late["losses"][0], "reference": ref_late["losses"][0]},
        {"name": "late_grad_gap", "value": lg["grad_gap"],
         "limit": lim["late_grad_gap"], "leaf": lg["grad_leaf"]},
        {"name": "late_update_gap", "value": lg["update_gap"],
         "limit": lim["late_update_gap"], "leaf": lg["update_leaf"],
         "left_out": lg["left_out"]},
    ]
    return {"record": record, "attempted": n_steps,
            "failed": n_steps - finite, "memory_peak_bytes": peak,
            "checks": checks}
