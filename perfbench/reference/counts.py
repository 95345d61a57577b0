"""Frozen counts of the work a configuration needs, from its sizes alone:
floating-point operations (a multiply-add is two) and bytes of HBM
traffic.  They count what the inputs need, not what a kernel does (no
padding, no masked tiles, no recompute), so a share of a peak computed
from them stays under 100% on a sound run.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet, dense, at the full
700 W power limit.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12      # tensor cores, dense bfloat16
HBM_BYTES_PER_S = 3.35e12     # HBM3


def _dims(m: Dict):
    hd = m["head_dim"] or m["d_model"] // m["n_heads"]
    return m["d_model"], m["d_ff"], hd, m["n_heads"], m["n_kv_heads"]


def layer_matmul_params(m: Dict) -> int:
    """Weights one layer multiplies by (q, k, v, o and the SwiGLU MLP)."""
    d, f, hd, H, KV = _dims(m)
    return 2 * d * H * hd + 2 * d * KV * hd + 3 * d * f


def layer_params(m: Dict) -> int:
    """Every weight of one layer: its products', norms' and biases'."""
    d, _, hd, H, KV = _dims(m)
    bias = (H + 2 * KV) * hd if m["qkv_bias"] else 0
    return layer_matmul_params(m) + 2 * d + bias


def head_params(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def attention_flops(m: Dict, keys: int) -> int:
    """One query's score and value products against ``keys`` keys, in
    every layer."""
    _, _, hd, H, _ = _dims(m)
    return 4 * H * hd * keys * m["n_layers"]


def causal_pairs(length: int) -> int:
    """(query, key) pairs under a causal mask over ``length`` tokens."""
    return length * (length + 1) // 2


def prefill_flops(m: Dict, length: int) -> int:
    """A prompt of ``length`` tokens: every layer's products at every
    token, causal attention, the head at the last token."""
    _, _, hd, H, _ = _dims(m)
    return (2 * layer_matmul_params(m) * m["n_layers"] * length
            + 4 * H * hd * causal_pairs(length) * m["n_layers"]
            + 2 * head_params(m))


def decode_flops(m: Dict, keys: int) -> int:
    """One decoded token that attends ``keys`` keys (itself included)."""
    return (2 * (layer_matmul_params(m) * m["n_layers"] + head_params(m))
            + attention_flops(m, keys))


def train_step_flops(m: Dict, rows: int, seq: int) -> int:
    """A step over ``rows`` x ``seq`` tokens: 6 x parameters x tokens for
    the products (forward, and twice that backward) and three times the
    forward's causal attention; the embedding is a lookup."""
    _, _, hd, H, _ = _dims(m)
    n = layer_matmul_params(m) * m["n_layers"] + head_params(m)
    attn = 4 * H * hd * causal_pairs(seq) * m["n_layers"] * rows
    return 6 * n * rows * seq + 3 * attn


def causal_attention_call(m: Dict, lengths: Iterable[int],
                          item: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one layer's causal attention over prompts of
    ``lengths`` tokens: q, k and v read once and the output written once."""
    _, _, hd, H, KV = _dims(m)
    flops = sum(4 * H * hd * causal_pairs(n) for n in lengths)
    nbytes = sum(n * hd * (2 * H + 2 * KV) * item for n in lengths)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def decode_step_bytes(m: Dict, keys: Iterable[int], item: int = 2) -> int:
    """One decode step over the rows attending ``keys`` keys: every weight
    read once (the embedding's rows of these tokens only), each row's
    earlier K/V read once and its new K/V written once: ``keys`` positions
    a row."""
    keys = list(keys)
    d, _, hd, _, KV = _dims(m)
    L = m["n_layers"]
    kv_row = 2 * KV * hd * item * L          # one position's K and V
    weights = (layer_params(m) * L + head_params(m) + d) * item
    return weights + len(keys) * d * item + sum(keys) * kv_row
