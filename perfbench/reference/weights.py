"""The weights of a run, made from its seed.

The benchmark makes the weights, not the program: the same function fills
the program's parameters at set-up and gives the plain reference the same
values again after the program is freed.  Each layer (and the top level:
embedding, final norm, head) is one ``torch.randn`` call of the layer's
whole size, drawn on the device by a generator seeded from (seed, layer),
in the type the model is served in, then cut into leaves.  So any one
layer can be drawn again alone, which lets the reference run layer by
layer.

The rule (a departure from the published initialisation, which random
weights do not follow anyway): a matrix stored ``[in, out]`` is
N(0, 1/in); the embedding table N(0, 1); a norm scale 1 + 0.1 N(0, 1); a
bias 0.1 N(0, 1).  Norm scales and biases are drawn, not set to one and
zero, so that their paths are exercised.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(model: Dict) -> int:
    """The rows the embedding and head hold: the vocabulary rounded up to
    a multiple of 256, as the program stores it."""
    v = model["vocab_size"]
    return (v + 255) // 256 * 256


def head_dim(model: Dict) -> int:
    return model["head_dim"] or model["d_model"] // model["n_heads"]


def layer_spec(model: Dict) -> Dict[str, Tuple[int, ...]]:
    """name → shape of one layer of the dense family."""
    d, f, hd = model["d_model"], model["d_ff"], head_dim(model)
    q, kv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    spec = {"ln1": (d,), "wq": (d, q), "wk": (d, kv), "wv": (d, kv),
            "wo": (q, d), "ln2": (d,), "w1": (d, f), "w2": (f, d),
            "w3": (d, f)}
    if model["qkv_bias"]:
        spec.update(bq=(q,), bk=(kv,), bv=(kv,))
    return dict(sorted(spec.items()))


def top_spec(model: Dict) -> Dict[str, Tuple[int, ...]]:
    vp, d = padded_vocab(model), model["d_model"]
    return {"embed": (vp, d), "final_ln": (d,), "lm_head": (d, vp)}


def _seed(seed: int, tag: int) -> int:
    """A 63-bit generator seed for (run seed, tag)."""
    state = np.random.SeedSequence([int(seed), int(tag)]).generate_state(
        2, np.uint64)
    return int((int(state[0]) << 1 ^ int(state[1])) & (2 ** 63 - 1))


def _transform(name: str, x: torch.Tensor, shape) -> torch.Tensor:
    if name.startswith("ln") or name == "final_ln":
        return 1.0 + 0.1 * x
    if name.startswith("b"):
        return 0.1 * x
    if name == "embed":
        return x
    return x / math.sqrt(shape[0])


def draw(spec: Dict[str, Tuple[int, ...]], seed: int, tag: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One group of leaves: a single normal draw of their whole size, cut
    in ``spec``'s order and shaped by the rule."""
    n = sum(math.prod(s) for s in spec.values())
    gen = torch.Generator(device=device).manual_seed(_seed(seed, tag))
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in spec.items():
        k = math.prod(shape)
        x = flat[at:at + k].view(shape).float()
        out[name] = _transform(name, x, shape).to(dtype)
        at += k
    return out


def layer_weights(model: Dict, seed: int, i: int, device, dtype=None):
    """Layer ``i``'s leaves."""
    dtype = dtype or DTYPES[model["param_dtype"]]
    return draw(layer_spec(model), seed, i + 1, device, dtype)


def top_weights(model: Dict, seed: int, device, dtype=None):
    """The embedding, final norm and head."""
    dtype = dtype or DTYPES[model["param_dtype"]]
    return draw(top_spec(model), seed, 0, device, dtype)


def expected_names(model: Dict):
    names = {f"top.{n}" for n in top_spec(model)}
    for i in range(model["n_layers"]):
        names |= {f"layers.{i}.{n}" for n in layer_spec(model)}
    return names


@torch.no_grad()
def fill(named: Dict[str, torch.Tensor], model: Dict, seed: int) -> None:
    """Copies the run's weights into the program's parameters ``named``
    (``layers.<i>.<leaf>``, ``top.<leaf>``), which must be exactly these
    leaves with these shapes."""
    if set(named) != expected_names(model):
        extra = sorted(set(named) ^ expected_names(model))[:8]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's spec: {extra}")
    device = next(iter(named.values())).device
    for n, t in top_weights(model, seed, device).items():
        named[f"top.{n}"].copy_(t)
    for i in range(model["n_layers"]):
        for n, t in layer_weights(model, seed, i, device).items():
            named[f"layers.{i}.{n}"].copy_(t)
