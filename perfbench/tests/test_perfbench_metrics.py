"""The metric readers over hand-made records: rates, tails and shares are
taken over all the work of the window; the trace's reduction to busy time
and idle gaps."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import common  # noqa: E402
import run  # noqa: E402
from reference import counts  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
TINY = {"d_model": 4, "d_ff": 6, "head_dim": 2, "n_heads": 2,
        "n_kv_heads": 1, "vocab_size": 10, "n_layers": 3, "qkv_bias": True}


def read(name, rec):
    return run._reader(name)(rec)


def serve_record():
    # window (10, 20]: request a sent at 9, tokens at 9.5 (before), 11, 12;
    # b sent at 10.5, tokens at 11, 11, 13, 21 (after); c sent at 15,
    # first token at 16
    requests = [{"sent": 9.0, "times": [9.5, 11.0, 12.0]},
                {"sent": 10.5, "times": [11.0, 11.0, 13.0, 21.0]},
                {"sent": 15.0, "times": [16.0]}]
    steps = [
        {"t_a": 10.0, "t_b": 11.0, "admitted": 1,
         "prefills": [[8, 1, [5]]], "decode_keys": [3, 6]},
        {"t_a": 11.0, "t_b": 12.0, "admitted": 0, "prefills": [],
         "decode_keys": [4, 7]},
        {"t_a": 12.0, "t_b": 13.0, "admitted": 0, "prefills": [],
         "decode_keys": [8]},
    ]
    return {"kind": "serve", "model": TINY, "setup_s": 4.5, "t_start": 10.0,
            "t_end": 20.0, "window_s": 10.0, "requests": requests,
            "steps": steps, "traced_steps": [], "trace": None,
            "config": {"kernel_sources": {}}}


def test_serve_rates_and_tails_use_every_request_of_the_window():
    rec = serve_record()
    assert read("setup_s", rec) == 4.5
    # tokens in (10, 20]: 11, 12 of a; 11, 11, 13 of b; 16 of c
    assert read("decode_tokens_per_s", rec) == pytest.approx(0.6)
    # first tokens in the window: b (0.5 s) and c (1 s); a's came before
    assert read("ttft_p95_ms", rec) == pytest.approx(
        np.percentile([500.0, 1000.0], 95))
    # gaps inside: a 11 -> 12; b 11 -> 11, 11 -> 13 (13 -> 21 ends after)
    assert read("itl_p95_ms", rec) == pytest.approx(
        np.percentile([1000.0, 0.0, 2000.0], 95))


def test_long_prompt_itl_reads_the_gaps_as_the_end_to_end_one_does():
    rec = serve_record()
    assert read("itl_p95_ms.long-prompt", rec) == pytest.approx(
        read("itl_p95_ms", rec))
    assert read("itl_p95_ms.long-prompt", {"kind": "train"}) is None


def test_server_steps_split_by_admission():
    rec = serve_record()
    assert read("step_ms.admit", rec) == pytest.approx(1000.0)
    assert read("step_ms.decode", rec) == pytest.approx(1000.0)
    want = (counts.decode_step_bytes(TINY, [4, 7])
            + counts.decode_step_bytes(TINY, [8])) / 2.0
    assert read("decode_hbm_share", rec) == pytest.approx(
        100 * want / counts.HBM_BYTES_PER_S)


def test_mfu_serve_counts_prefills_and_decoded_tokens():
    rec = serve_record()
    flops = counts.prefill_flops(TINY, 5) + sum(
        counts.decode_flops(TINY, k) for k in (3, 6, 4, 7, 8))
    assert read("mfu.serve", rec) == pytest.approx(
        100 * flops / (10.0 * counts.PEAK_BF16_FLOPS))


def test_trace_metrics_are_silent_without_a_trace():
    rec = serve_record()
    for name in ("k2_roofline", "idle.serve"):
        assert read(name, rec) is None


def test_k2_roofline_reads_the_attention_kernels_of_traced_prefills():
    rec = serve_record()
    rec["config"]["kernel_sources"] = {
        "attention": "src/repro_torch/kernels/csrc/flash_attention.cu"}
    rec["traced_steps"] = rec["steps"][:1]
    rec["trace"] = {"busy_s": 0.5, "window_s": 1.0, "idle": {},
                    "device_ops": {"void fa_mma_kernel<128>(Params)": 2e-6,
                                   "nvjet_gemv": 1.0}}
    bound = 3 * counts.bound_s(*counts.causal_attention_call(TINY, [5]))
    assert read("k2_roofline", rec) == pytest.approx(100 * bound / 2e-6)
    assert read("idle.serve", rec) == pytest.approx(50.0)


def test_train_metrics():
    rec = {"kind": "train", "model": TINY, "setup_s": 3.0, "t_start": 0.0,
           "t_end": 4.0, "window_s": 4.0, "steps": 2, "tokens_per_step": 8,
           "rows": 2, "seq": 4, "data_s": [0.01, 0.03],
           "trace": {"busy_s": 0.9, "window_s": 1.0, "idle": {},
                     "device_ops": {
                         "void at::native::vectorized_elementwise_kernel<4>":
                             0.3,
                         "void at::native::reduce_kernel<512, 1>": 0.1,
                         "sm90_xmma_gemm_bf16": 0.6}},
           "config": {}}
    assert read("train_tokens_per_s", rec) == pytest.approx(4.0)
    assert read("mfu.train", rec) == pytest.approx(
        100 * 2 * counts.train_step_flops(TINY, 2, 4)
        / (4.0 * counts.PEAK_BF16_FLOPS))
    assert read("data_ms.train", rec) == pytest.approx(20.0)
    assert read("elementwise_share.train", rec) == pytest.approx(40.0)
    assert read("idle.train", rec) == pytest.approx(10.0)
    assert read("decode_tokens_per_s", rec) is None


def _ev(name, start, dur, kind="CUDA"):
    return SimpleNamespace(name=lambda: name,
                           device_type=lambda: f"DeviceType.{kind}",
                           start_ns=lambda: start, duration_ns=lambda: dur,
                           is_user_annotation=lambda: False)


def test_trace_reduction_unions_device_time_and_names_gaps():
    spans = [(0, 100, "decode"), (100, 200, "admit")]
    events = [_ev("cudaGraphLaunch", 0, 5, "CPU"),
              _ev("k1", 10, 30), _ev("k2", 20, 30),
              _ev("k1", 60, 50), _ev("k3", 150, 20)]
    r = common.reduce_events(events, 2e-7, spans, (0, 200))
    assert r["aligned"]
    assert r["busy_s"] == pytest.approx(110e-9)    # [10,50] [60,110] [150,170]
    assert r["device_ops"]["k1"] == pytest.approx(80e-9)
    assert r["idle"] == {"decode": pytest.approx(10e-9),
                         "admit": pytest.approx(40e-9)}
    assert common.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                              ["c", 2.0]]
    late = common.reduce_events(events, 2e-7, spans, (10 ** 9, 2 * 10 ** 9))
    assert not late["aligned"] and set(late["idle"]) == {"clocks disagree"}


def test_kernel_names_come_from_the_source():
    src = HERE.parent / "src/repro_torch/kernels/csrc/flash_attention.cu"
    names = common.kernel_names(src)
    assert sorted(names) == ["fa_mma_kernel", "fa_simt_kernel"]
    assert common.is_kernel("void fa_mma_kernel<128>(Params)", names)
    assert not common.is_kernel("void xfa_mma_kernel2(Params)", names)


def test_every_metric_has_its_reader_and_cells_report_what_they_must():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert (HERE / "metrics" / f"{n}.py").exists(), n
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in run.metrics_of(BENCH, cell["name"], False)]
        per = run.metrics_of(BENCH, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:          # what a per-layer metric moves is reported
            assert m["moves"] in e2e


def test_percentile_is_linear():
    assert common.percentile([0.0, 10.0], 95) == pytest.approx(9.5)
