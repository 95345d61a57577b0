"""Runs of the harness on the CPU at a reduced size (its look for a card
skipped) with the timed path sound, and broken underneath: ``correct``
must come out true, then false for each fault the cell can have."""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve.decode import BatchedServer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SERVE = [w["name"] for w in BENCH["workloads"] if w["traffic"] != "train"]
TRAIN = [w["name"] for w in BENCH["workloads"] if w["traffic"] == "train"]


def small_run(cell_name, seconds=2.0):
    cell, config, traffic, limits = run.load_cell(BENCH, cell_name)
    model = get_config(config["name"]).reduced()
    if traffic["kind"] == "train":
        # float32: a leaf of a reduced layer is too small for its change's
        # bfloat16 rounding to stay under a limit set at the cell's size
        model = dataclasses.replace(model, param_dtype="float32")
        traffic = dict(traffic, global_batch=4, seq_len=32)
    else:
        traffic = dict(traffic, slots=4, clients=4, max_len=96,
                       prompt={"dist": "uniform", "min": 8, "max": 60},
                       output={"dist": "uniform", "min": 4, "max": 24})
    config = dict(config, model=dataclasses.asdict(model))
    return run.execute(BENCH, cell, config, traffic, limits, seed=2 ** 31 + 1,
                       seconds=seconds, trace=False, device="cpu", aot=False)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(cell):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", SERVE)
def test_a_token_altered_where_it_is_produced_fails(cell, monkeypatch):
    decode = BatchedServer._decode

    def altered(self, toks):
        return (decode(self, toks) + 1) % self.model.cfg.vocab_size
    monkeypatch.setattr(BatchedServer, "_decode", altered)
    assert not small_run(cell)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_the_program_s_int8_kv_cache_fails(cell, monkeypatch):
    """The control: the program's own lower precision, its int8 K/V
    cache, fails ``kv_gap``."""
    import drivers.serve as S
    monkeypatch.setattr(S, "build", functools.partial(S.build,
                                                      kv_quant=True))
    res = small_run(cell)
    assert not res["correct"]
    assert res["checks"]["kv_gap"]["value"] > \
        res["checks"]["kv_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_fault_after_the_first_steps_fails(cell, monkeypatch):
    """A step that leaves out half of its batch only after the job's first
    steps (a path taken once warm) fails the late step's numbers."""
    make = steps.make_train_step

    def late_half(model, opt_cfg, **kw):
        step = make(model, opt_cfg, **kw)
        calls = []

        def maybe_half(params, state, batch):
            calls.append(1)
            if len(calls) > 3:
                rows = next(iter(batch.values())).shape[0] // 2
                batch = {k: v[:rows] for k, v in batch.items()}
            return step(params, state, batch)
        return maybe_half
    monkeypatch.setattr(steps, "make_train_step", late_half)
    res = small_run(cell)
    assert not res["correct"]
    for name in ("loss_gap", "grad_gap", "update_gap"):
        assert res["checks"][name]["value"] <= res["checks"][name]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged_fails(cell, monkeypatch):
    make = steps.make_train_step

    def unchanged(model, opt_cfg, **kw):
        step = make(model, opt_cfg, **kw)

        def frozen(params, state, batch):
            keep = {n: p.detach().clone() for n, p in params.items()}
            _, _, m = step(params, state, batch)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(keep[n])
            return params, state, m
        return frozen
    monkeypatch.setattr(steps, "make_train_step", unchanged)
    res = small_run(cell)
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["late_update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_fails(cell, monkeypatch):
    make = steps.make_train_step

    def halved(model, opt_cfg, **kw):
        step = make(model, opt_cfg, **kw)

        def half(params, state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(params, state, {k: v[:rows] for k, v in
                                        batch.items()})
        return half
    monkeypatch.setattr(steps, "make_train_step", halved)
    assert not small_run(cell)["correct"]


def test_the_steps_work_does_not_depend_on_the_seed():
    """In the closed loop every seed admits the same prompt lengths and
    decodes the same contexts at every step."""
    import drivers.serve as S
    import workload
    cell, config, traffic, limits = run.load_cell(BENCH, SERVE[0])
    model = dataclasses.asdict(get_config(config["name"]).reduced())
    traffic = dict(traffic, slots=4, clients=4, max_len=96,
                   prompt={"dist": "uniform", "min": 8, "max": 60},
                   output={"dist": "uniform", "min": 4, "max": 24})
    work = []
    for seed in (2 ** 31 + 5, 7):
        ctx = {"config": dict(config, model=model), "traffic": traffic,
               "seed": seed, "device": "cpu", "aot": False}
        _, server = S.build(ctx)
        loop = S.Loop(server, workload.Requests(traffic, model["vocab_size"],
                                                seed), traffic["clients"])
        for _ in range(80):
            loop.step()
        work.append([(s["admitted"], sorted((b, r, sorted(v))
                                            for b, r, v in s["prefills"]),
                      sorted(s["decode_keys"])) for s in loop.steps])
    assert work[0] == work[1]
