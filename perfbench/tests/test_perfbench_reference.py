"""The plain reference against the port's ``LM`` and train step at a
reduced size, in float32, on the CPU.  (The test imports the port; the
reference does not.)"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import drivers.train as T  # noqa: E402
from reference import serve as ref_serve  # noqa: E402
from reference import train as ref_train  # noqa: E402
from reference import weights as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


def small(name, dtype="float32"):
    return dataclasses.asdict(dataclasses.replace(
        get_config(name).reduced(), param_dtype=dtype))


@pytest.mark.parametrize("name", CONFIGS)
def test_the_files_hold_the_port_s_configurations(name):
    """Every size the benchmark runs is the port's own (notes aside)."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    port = dataclasses.asdict(get_config(name))
    assert {k: v for k, v in cfg["model"].items() if k != "source"} == \
        {k: v for k, v in port.items() if k != "source"}
    assert cfg["reduced"] == []


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_fill_the_program_and_repeat(name):
    m = small(name, "bfloat16")
    model = get_model(get_config(name).reduced(), device="cpu")
    W.fill(dict(model.named_parameters()), m, 2 ** 31 + 3)
    again = W.layer_weights(m, 2 ** 31 + 3, 1, "cpu")
    for leaf, t in again.items():
        assert torch.equal(model.layers[1].tensors()[leaf], t)
    other = W.layer_weights(m, 2 ** 31 + 4, 1, "cpu")
    assert not torch.equal(other["wq"], again["wq"])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_equal_the_port_s(name):
    m = small(name)
    model = get_model(get_config(name).reduced().__class__(**m), device="cpu")
    W.fill(dict(model.named_parameters()), m, 11)
    tokens = np.random.default_rng(0).integers(0, m["vocab_size"], 24)
    with torch.no_grad():
        hidden, _ = model.forward(torch.as_tensor(tokens[None]))
        want = model.logits_fn(hidden)[0, :, :m["vocab_size"]]
    got = ref_serve._logits(m, 11, [(tokens[:1], list(tokens[1:]) + [0])],
                            "cpu", ref_serve.M.mm)[0]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_served_gap_reads_zero_for_greedy_tokens_and_more_for_others():
    m = small("glm4-9b")
    prompt = np.arange(5, 17)
    logits = ref_serve._logits(m, 5, [(prompt, [0, 0, 0, 0])], "cpu",
                               ref_serve.M.mm)[0]
    greedy = [int(logits[0].argmax())]
    for _ in range(3):
        greedy.append(int(ref_serve._logits(
            m, 5, [(prompt, greedy + [0])], "cpu",
            ref_serve.M.mm)[0][-1].argmax()))
    assert max(ref_serve.served_gaps(m, 5, [(prompt, greedy)], "cpu")) \
        == pytest.approx(0.0, abs=1e-6)
    worst = [int(x) for x in logits.argmin(dim=1)]
    assert min(ref_serve.served_gaps(m, 5, [(prompt, worst[:1])], "cpu")) > 1


def test_reference_steps_equal_the_port_s_train_step():
    m = small("stablelm-3b")
    job = dict(json.loads((HERE / "traffic" / "train.json").read_text()),
               global_batch=4, seq_len=32)
    ctx = {"config": {"model": m}, "traffic": job, "device": "cpu",
           "seed": 2 ** 31 + 9}
    model, step_fn, opt_cfg, pipeline = T.build(ctx)
    _, _, _, readings = T.first_steps(model, step_fn, opt_cfg, pipeline, job,
                                      ctx["seed"], "cpu")
    ref = ref_train.run(m, job, ctx["seed"], "cpu", job["reference_steps"])
    g = T.gaps(readings, ref)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    assert g["update_gap"] < 1e-3
    assert T.rows_off(readings, m, job, ctx["seed"]) == 0


def test_kv_gaps_read_the_port_s_cache_and_its_int8_cache():
    """The reference's K/V equal what the port's prefill caches (float32);
    the port's int8 cache reads its rounding."""
    m = small("glm4-9b")
    tokens = np.random.default_rng(1).integers(0, m["vocab_size"], 40)
    got = {}
    for quant in (False, True):
        model = get_model(get_config("glm4-9b").reduced().__class__(**m),
                          device="cpu", kv_quant=quant)
        W.fill(dict(model.named_parameters()), m, 13)
        with torch.no_grad():
            _, cache = model.prefill(torch.as_tensor(tokens[None]))
        kv = {n: cache[n][:, 0].float() * (cache[f"{n}_scale"][:, 0].float()
                                           if quant else 1.0)
              for n in ("k", "v")}
        got[quant] = ref_serve.kv_gaps(m, 13, [(tokens, kv)], "cpu")
    assert len(got[False]) == m["n_layers"]
    assert max(g["rel"] for g in got[False]) < 1e-5
    assert got[True][0]["fine"] > 100 * got[False][0]["fine"]
    assert 0.001 < got[True][0]["fine"] < 0.004


def test_reference_resumes_the_port_s_step_from_its_state():
    m = small("stablelm-3b")
    job = dict(json.loads((HERE / "traffic" / "train.json").read_text()),
               global_batch=4, seq_len=32)
    ctx = {"config": {"model": m}, "traffic": job, "device": "cpu",
           "seed": 2 ** 31 + 10}
    model, step_fn, opt_cfg, pipeline = T.build(ctx)
    params, state, data, _ = T.first_steps(model, step_fn, opt_cfg, pipeline,
                                           job, ctx["seed"], "cpu")
    params, state, _ = step_fn(params, state, pipeline.make_global_batch(
        data, 3, device="cpu"))
    kept, late = T.late_step(params, state, step_fn, opt_cfg, pipeline, data,
                             4, "cpu")
    assert kept["step"] == 4 and late["first"] == 4
    ref = ref_train.resume(m, job, ctx["seed"], "cpu", kept, 4)
    g = T.gaps(late, ref)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    assert g["update_gap"] < 1e-3
    assert T.rows_off(late, m, job, ctx["seed"]) == 0
