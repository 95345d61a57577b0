"""The serving driver on the card at a reduced size: CUDA graphs, K2 at the
attention site, a trace.  Run on the H100 with
``python3 -m pytest -q -m cuda perfbench/tests``; skipped without a card."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")


@pytest.mark.cuda
def test_a_reduced_chat_run_on_graphs_is_correct_and_traced(card):
    cell, config, traffic, limits = run.load_cell(BENCH, "glm4-9b.chat")
    config = dict(config, model=dataclasses.asdict(
        get_config("glm4-9b").reduced()))
    traffic = dict(traffic, slots=4, clients=4, max_len=128,
                   prompt={"dist": "uniform", "min": 8, "max": 90},
                   output={"dist": "uniform", "min": 4, "max": 30})
    res = run.execute(BENCH, cell, config, traffic, limits, seed=2 ** 31 + 2,
                      seconds=2.0, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "k2_roofline" in res["metrics"]
    assert 0 < res["metrics"]["k2_roofline"]["value"] <= 100
