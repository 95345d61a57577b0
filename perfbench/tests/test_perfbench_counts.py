"""The frozen operation and byte counts against values worked by hand at
tiny shapes."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from reference import counts  # noqa: E402

# d 4, ffn 6, 2 heads of 2 (q 4 wide), 1 KV head (2 wide), vocab 10, 3 layers
TINY = {"d_model": 4, "d_ff": 6, "head_dim": 2, "n_heads": 2,
        "n_kv_heads": 1, "vocab_size": 10, "n_layers": 3, "qkv_bias": True}


def test_parameters():
    # q 4x4 + o 4x4 + k 4x2 + v 4x2 + MLP 3 x 4x6
    assert counts.layer_matmul_params(TINY) == 16 + 16 + 8 + 8 + 72
    # + 2 norms of 4 + biases 4 + 2 + 2
    assert counts.layer_params(TINY) == 120 + 8 + 8
    assert counts.head_params(TINY) == 40


def test_causal_pairs():
    assert [counts.causal_pairs(n) for n in (1, 2, 3, 4)] == [1, 3, 6, 10]


def test_prefill_of_three_tokens():
    # products: 2 x 120 x 3 layers x 3 tokens; attention: 4 x 2 heads x 2 x
    # 6 pairs x 3 layers; head at the last token: 2 x 40
    assert counts.prefill_flops(TINY, 3) == 2160 + 288 + 80


def test_decode_token():
    # 2 x (120 x 3 + 40) + 4 x 2 x 2 x 5 keys x 3 layers
    assert counts.decode_flops(TINY, 5) == 800 + 240


def test_train_step():
    # 6 x (360 + 40) x 2 rows x 4 tokens + 3 x (4 x 2 x 2 x 10 pairs x 3
    # layers x 2 rows)
    assert counts.train_step_flops(TINY, 2, 4) == 19200 + 3 * 960


def test_attention_call():
    flops, nbytes = counts.causal_attention_call(TINY, [2, 3])
    assert flops == 4 * 2 * 2 * (3 + 6)
    # per token: q and o 2 heads x 2, k and v 1 x 2, bf16
    assert nbytes == (2 + 3) * 2 * (2 * 2 + 2 * 1) * 2


def test_decode_step_bytes():
    # weights (136 x 3 + 40 + final norm 4) x 2 bytes; 2 embedding rows;
    # K/V: (3 + 5) positions x 2 x 1 x 2 x 2 bytes x 3 layers
    got = counts.decode_step_bytes(TINY, [3, 5])
    assert got == (408 + 40 + 4) * 2 + 2 * 4 * 2 + 8 * 24


def test_bound_takes_the_larger_term():
    assert counts.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_glm4_decode_weights_dominate():
    import json
    m = json.loads((HERE / "configs" / "glm4-9b.json").read_text())["model"]
    nbytes = counts.decode_step_bytes(m, [200] * 16)
    # 8.78e9 weights of 2 bytes (the embedding table is not read, only 16
    # of its rows), plus 3,200 positions of 40 KiB
    assert 17.5e9 < nbytes < 17.8e9
