"""The check of served tokens: the reference runs once over each sampled
prompt with its served tokens (teacher forced), and reads at each served
position how far the served token's logit lies below the reference's best
logit there, in units of that position's logit spread (standard
deviation).  A greedy server that computes the model reads near 0; a token
altered where it is produced reads several units.

``control_gaps`` is the control: the reference in a lower precision at
the same positions, whose own best token is read against the reference
the same way.

``kv_gaps`` reads the K/V that the program's cache holds for the slots
live when the window closed against the reference's K/V of the same
tokens, layer by layer: the precision of what the cache stores, which the
served tokens cannot show (bf16's rounding through the layers sets their
widest gap whatever the cache holds).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference import model as M
from reference import weights as W


def _logits(model: Dict, seed: int, seqs: Sequence[Tuple[np.ndarray, list]],
            device, matmul) -> List[torch.Tensor]:
    """float32 logits [n_served, V] of each (prompt, served) at the
    positions that produced the served tokens, layer by layer."""
    M.check_supported(model)
    V = model["vocab_size"]
    top = W.top_weights(model, seed, device)
    hs, places = [], []
    for prompt, served in seqs:
        ids = np.concatenate([prompt, np.asarray(served[:-1], np.int64)])
        tokens = torch.as_tensor(ids, dtype=torch.long, device=device)
        hs.append(top["embed"][tokens].float()[None])
        places.append(len(prompt) - 1 + np.arange(len(served)))
    with M.exact_f32():
        for i in range(model["n_layers"]):
            p = {n: t.float() for n, t in
                 W.layer_weights(model, seed, i, device).items()}
            for j, h in enumerate(hs):
                pos = torch.arange(h.shape[1], device=device)
                hs[j] = M.layer(h, p, model, pos, matmul)
            del p
        head = top["lm_head"][:, :V].float()
        final = top["final_ln"].float()
        out = []
        for h, at in zip(hs, places):
            h = M.rms_norm(h[0, torch.as_tensor(at, device=device)], final,
                           model["norm_eps"])
            out.append(matmul(h, head))
    return out


def _gap(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """(best - logit of ``picked``) / spread, at each row of ``ref``."""
    got = ref.gather(1, picked[:, None])[:, 0]
    return (ref.max(dim=1).values - got) / ref.std(dim=1)


@torch.no_grad()
def served_gaps(model: Dict, seed: int, seqs, device) -> List[float]:
    """The reference's gap of every served token of ``seqs``."""
    ref = _logits(model, seed, seqs, device, M.mm)
    out = []
    for r, (_, served) in zip(ref, seqs):
        picked = torch.as_tensor(served, dtype=torch.long, device=device)
        out.extend(_gap(r, picked).tolist())
    return out


@torch.no_grad()
def control_gaps(model: Dict, seed: int, seqs, device) -> List[float]:
    """The reference's gap of the token the float8 control puts first at
    each served position of ``seqs``."""
    ref = _logits(model, seed, seqs, device, M.mm)
    low = _logits(model, seed, seqs, device, M.fp8_mm)
    out = []
    for r, c in zip(ref, low):
        out.extend(_gap(r, c.argmax(dim=1)).tolist())
    return out


def _fine(got: torch.Tensor, want: torch.Tensor):
    """(squared error, squared scale) over the entries of ``want`` under a
    tenth of their row's largest (a row: one position and head), each
    error in units of that row's largest."""
    top = want.abs().amax(dim=-1, keepdim=True).expand_as(want)
    small = want.abs() < 0.1 * top
    return (float((got - want)[small].square().sum()),
            float(top[small].square().sum()))


@torch.no_grad()
def kv_gaps(model: Dict, seed: int, live, device,
            layers: int = 0) -> List[Dict[str, float]]:
    """For each of the first ``layers`` layers (0: all), the program's
    cached K and V of the ``live`` slots against the reference's, over the
    rows of every slot, the larger of K's and V's: ``rel``, ||program -
    reference|| / ||reference||; ``fine``, the error on the entries under a
    tenth of their row's largest, in units of that largest (how finely the
    cache resolves a row's small values: bfloat16 keeps each entry's own
    relative precision, a cache scaled by the row's largest does not).
    ``live`` holds (tokens fed, {"k", "v": [layers, tokens, KV, hd]}) a
    slot."""
    M.check_supported(model)
    top = W.top_weights(model, seed, device)
    hs = [top["embed"][torch.as_tensor(np.asarray(ids, np.int64),
                                       device=device)].float()[None]
          for ids, _ in live]
    del top
    out = []
    with M.exact_f32():
        for i in range(layers or model["n_layers"]):
            p = {n: t.float() for n, t in
                 W.layer_weights(model, seed, i, device).items()}
            sums = {(n, w): [0.0, 0.0] for n in "kv" for w in ("rel", "fine")}
            for j, h in enumerate(hs):
                kv = []
                pos = torch.arange(h.shape[1], device=device)
                hs[j] = M.layer(h, p, model, pos, M.mm, kv=kv)
                for name, want in zip("kv", kv[0]):
                    want = want[0]
                    got = live[j][1][name][i].to(device).float()
                    for w, (a, b) in (
                            ("rel", (float((got - want).square().sum()),
                                     float(want.square().sum()))),
                            ("fine", _fine(got, want))):
                        sums[name, w][0] += a
                        sums[name, w][1] += b
            del p
            out.append({w: max(math.sqrt(sums[n, w][0] / sums[n, w][1])
                               for n in "kv") for w in ("rel", "fine")})
    return out
