"""Plain PyTorch reference of a training cell's first steps.

From the seed's weights (their stored values, kept as the configuration
stores them: bfloat16) and the seed's token stream, it runs the job's
steps with every product in float32: microbatches whose mean NLL
gradients are averaged, clipping by the global norm, then AdamW with
float32 moments, the learning rate warmed up and decayed on a cosine, and
weight decay on every parameter of a layer and on the top level's
matrices; each updated weight is rounded to bfloat16 as it is stored.
Each layer is recomputed in the backward pass (``checkpoint``) so that the
float32 activations fit.

It returns what the train driver compares: each step's loss, each leaf's
norm of the first step's gradient as AdamW takes it (after clipping), and
each leaf's norm of the change of its weights over the steps.  ``resume``
does the same for one later step, from the program's own state.

``mode`` plants what a check must catch, in the reference put in the
program's place: ``"fp8"`` the control (every product in float8),
``"half"`` half of each microbatch left out and the mean taken over the
rest.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import data as D
from reference import model as M
from reference import weights as W


def lr_at(opt: Dict, step: int) -> float:
    """The learning rate of step ``step`` (counted from 1)."""
    warmup, total = opt["warmup_steps"], opt["total_steps"]
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    ratio = opt["min_lr_ratio"]
    return opt["lr"] * warm * (ratio + (1 - ratio) * cos)


def decays(name: str) -> bool:
    return name.startswith("layers.") or name in ("top.embed", "top.lm_head")


def _initial(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    out = {f"top.{n}": t for n, t in
           W.top_weights(model, seed, device).items()}
    for i in range(model["n_layers"]):
        out.update({f"layers.{i}.{n}": t for n, t in
                    W.layer_weights(model, seed, i, device).items()})
    return out


def loss_of(P, model: Dict, tokens, targets, matmul):
    """Mean NLL of the rows ``tokens`` → ``targets``."""
    V, L = model["vocab_size"], model["n_layers"]
    names = list(W.layer_spec(model))
    x = F.embedding(tokens, P["top.embed"])
    pos = torch.arange(tokens.shape[1], device=tokens.device)

    for i in range(L):
        def block(x, *ws):
            return M.layer(x, dict(zip(names, ws)), model, pos, matmul)
        x = checkpoint(block, x, *[P[f"layers.{i}.{n}"] for n in names],
                       use_reentrant=False)
    h = M.rms_norm(x, P["top.final_ln"], model["norm_eps"])
    logits = matmul(h, P["top.lm_head"][:, :V])
    return F.cross_entropy(logits.reshape(-1, V), targets.reshape(-1))


def _step(P, mu, nu, model: Dict, job: Dict, seed: int, s: int, t: int,
          matmul, mode: Optional[str]):
    """The job's step on the stream's batch ``s`` (counted from 0) as the
    optimizer's step ``t`` (counted from 1), on the float32 weights ``P``
    and moments ``mu``, ``nu`` in place; each updated weight is rounded to
    its stored type.  Returns (loss, each leaf's gradient norm as AdamW
    took it)."""
    opt = job["optimizer"]
    store = W.DTYPES[model["param_dtype"]]
    B, S, A = job["global_batch"], job["seq_len"], job["accum"]
    rows = B // A
    tokens, targets = D.batch(model["vocab_size"], S, B, seed, s)
    tokens = torch.as_tensor(tokens, device=P["top.embed"].device)
    targets = torch.as_tensor(targets, device=tokens.device)
    total = 0.0
    for a in range(A):
        lo, hi = a * rows, (a + 1) * rows
        if mode == "half":
            hi = lo + rows // 2
        loss = loss_of(P, model, tokens[lo:hi], targets[lo:hi], matmul)
        loss.backward()
        total += float(loss.detach())
    with torch.no_grad():
        g = {n: p.grad.div_(A) for n, p in P.items()}
        norm = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
        scale = min(opt["clip_norm"] / (norm + 1e-9), 1.0)
        grads = {n: float(x.norm()) * scale for n, x in g.items()}
        lr = lr_at(opt, t)
        b1c = 1 - opt["b1"] ** t
        b2c = 1 - opt["b2"] ** t
        for n, p in P.items():
            gs = g[n] * scale
            mu[n].mul_(opt["b1"]).add_(gs, alpha=1 - opt["b1"])
            nu[n].mul_(opt["b2"]).add_(gs.square(), alpha=1 - opt["b2"])
            delta = (mu[n] / b1c) / ((nu[n] / b2c).sqrt() + opt["eps"])
            if decays(n):
                delta = delta + opt["weight_decay"] * p
            p.copy_((p - lr * delta).to(store).float())
            p.grad = None
        del g
    return total / A, grads


def run(model: Dict, job: Dict, seed: int, device, steps: int,
        mode: Optional[str] = None) -> Dict:
    M.check_supported(model)
    matmul = M.fp8_mm if mode == "fp8" else M.mm
    P = {n: t.float().requires_grad_(True)
         for n, t in _initial(model, seed, device).items()}
    mu = {n: torch.zeros_like(p) for n, p in P.items()}
    nu = {n: torch.zeros_like(p) for n, p in P.items()}
    losses, first_grads = [], {}
    with M.exact_f32():
        for s in range(steps):
            loss, grads = _step(P, mu, nu, model, job, seed, s, s + 1,
                                matmul, mode)
            losses.append(loss)
            if s == 0:
                first_grads = grads
    del mu, nu
    with torch.no_grad():
        start = _initial(model, seed, device)
        moved = {n: float((p - start[n].float()).norm())
                 for n, p in P.items()}
    return {"losses": losses, "grad_norms": first_grads,
            "delta_norms": moved}


def resume(model: Dict, job: Dict, seed: int, device, kept: Dict, s: int,
           mode: Optional[str] = None) -> Dict:
    """The job's step on batch ``s`` from the program's own state ``kept``
    (its weights, moments and step count, as the train driver keeps them on
    the host): each step after the first three is reached only through the
    program's state, since the reference cannot follow a whole window.
    Returns the step's loss, each leaf's gradient norm as AdamW took it and
    each leaf's norm of the change of its weights."""
    M.check_supported(model)
    matmul = M.fp8_mm if mode == "fp8" else M.mm
    def mine(tree):     # copies: the steps change them in place
        return {n: t.to(device, torch.float32, copy=True)
                for n, t in tree.items()}
    P = {n: t.requires_grad_(True) for n, t in mine(kept["params"]).items()}
    mu, nu = mine(kept["mu"]), mine(kept["nu"])
    with M.exact_f32():
        loss, grads = _step(P, mu, nu, model, job, seed, s,
                            kept["step"] + 1, matmul, mode)
    del mu, nu
    with torch.no_grad():
        moved = {n: float((p - kept["params"][n].to(device).float()).norm())
                 for n, p in P.items()}
    return {"losses": [loss], "grad_norms": grads, "delta_norms": moved}
