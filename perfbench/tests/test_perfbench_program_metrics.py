"""The readers of the program's own spans and counters
(``repro_torch.tracing``) over hand-made sessions: each returns its value,
and None without a trace, with a session that holds none of what it reads,
or from a program without the recorder."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import run  # noqa: E402
from repro_torch import tracing  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
MS = 1_000_000
SERVE = ("decode_device_ms", "decode_host_ms", "idle_in_step.serve",
         "prefill_pad_share", "prefill_wait_ms")
TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train",
         "data_draw_ms.train")


def read(name, rec):
    return run._reader(name)(rec)


def span(name, sid, parent, t0, t1, device=None, nested=True, **attrs):
    return {"name": name, "id": sid, "parent": parent, "thread": 1,
            "attrs": attrs, "nested": nested, "t0": t0 * MS, "t1": t1 * MS,
            "device": None if device is None else [d * MS for d in device],
            "captured": False}


def serve_session():
    """Two decode-only steps and one admission step, each ending in a
    readback; a request queued from 0 to its prefill at 42 and another
    from 30."""
    spans = [
        # step 0 [0, 10): decode replay 2 ms on the device, readback 3 ms
        span("serve.step", 0, None, 0, 10, admitted=0, live=2),
        span("serve.inputs", 1, 0, 1, 2, graph="decode"),
        span("serve.replay", 2, 0, 2, 3, device=[2, 4], graph="decode"),
        span("serve.readback", 3, 0, 3, 6, device=[4, 6], graph="decode"),
        span("serve.commit", 4, 0, 6, 9, rows=2),
        # step 1 [20, 26): replay 4 ms, readback 2 ms
        span("serve.step", 5, None, 20, 26, admitted=0, live=2),
        span("serve.replay", 6, 5, 20, 21, device=[20, 24], graph="decode"),
        span("serve.readback", 7, 5, 22, 24, device=[23, 24],
             graph="decode"),
        # step 2 [40, 60): a prefill, then a decode
        span("serve.step", 8, None, 40, 60, admitted=2, live=2),
        span("serve.prefill", 9, 8, 42, 50, bucket=16, rows=2, padded_rows=2,
             rids=[0, 1]),
        span("serve.replay", 10, 9, 43, 44, device=[43, 48],
             graph="prefill/16/2"),
        span("serve.readback", 11, 9, 44, 49, device=[48, 49],
             graph="prefill/16/2"),
        span("serve.replay", 12, 8, 51, 52, device=[51, 54], graph="decode"),
        span("serve.readback", 13, 8, 52, 55, device=[54, 55],
             graph="decode"),
        span("serve.queue", 14, None, 0, 42, nested=False, rid=0,
             prompt_len=10),
        span("serve.queue", 15, None, 30, 42, nested=False, rid=1,
             prompt_len=14),
    ]
    return {"spans": spans, "counters": {"serve.prefill_tokens": 24,
                                         "serve.prefill_positions": 32}}


def train_session():
    spans = [span("data.draw", 0, None, 0, 2, rows=8),
             span("data.copy", 1, None, 2, 5, bytes=1),
             span("train.step", 2, None, 5, 100, device=[5, 100], accum=2),
             span("train.forward", 3, 2, 5, 10, device=[5, 20], micro=0),
             span("train.backward", 4, 2, 10, 30, device=[20, 50], micro=0),
             span("train.forward", 5, 2, 30, 35, device=[50, 60], micro=1),
             span("train.backward", 6, 2, 35, 60, device=[60, 80], micro=1),
             span("train.update", 7, 2, 60, 100, device=[80, 100]),
             span("data.draw", 8, None, 100, 104, rows=8),
             span("data.copy", 9, None, 104, 105),
             span("train.step", 10, None, 105, 200, device=[105, 200]),
             span("train.forward", 11, 10, 105, 110, device=[105, 125]),
             span("train.backward", 12, 10, 110, 150, device=[125, 160]),
             span("train.update", 13, 10, 150, 200, device=[160, 190])]
    return {"spans": spans, "counters": {}}


def record(kind, traced=True):
    return {"kind": kind, "trace": {"busy_s": 1.0, "window_s": 1.0}
            if traced else None}


@pytest.fixture
def session(monkeypatch):
    """Hands the readers the session given."""
    def use(sess):
        monkeypatch.setattr(tracing, "session", lambda: sess)
    return use


def test_serving_readers_read_their_spans_and_counters(session):
    session(serve_session())
    rec = record("serve")
    # decode replays 2, 4 and 3 ms on the device
    assert read("decode_device_ms", rec) == pytest.approx(3.0)
    # decode-only steps less their readbacks and replays: 10 - 3 - 1 and
    # 6 - 2 - 1 host ms
    assert read("decode_host_ms", rec) == pytest.approx((6.0 + 3.0) / 2)
    # device busy [2, 6), [20, 24), [43, 49), [51, 55) (the input copies are
    # the host's): window 53 ms; idle under a step: [6, 10) in step 0,
    # [24, 26) in step 1, [40, 43) and [49, 51) in step 2; [10, 20) and
    # [26, 40) are the caller's
    assert read("idle_in_step.serve", rec) == pytest.approx(
        100.0 * (4 + 2 + 3 + 2) / 53)
    assert read("prefill_pad_share", rec) == pytest.approx(25.0)
    assert read("prefill_wait_ms", rec) == pytest.approx((42 + 12) / 2)


def test_training_readers_read_their_spans(session):
    session(train_session())
    rec = record("train")
    assert read("forward_ms.train", rec) == pytest.approx((15 + 10 + 20) / 2)
    assert read("backward_ms.train", rec) == pytest.approx((30 + 20 + 35) / 2)
    assert read("update_ms.train", rec) == pytest.approx((20 + 30) / 2)
    assert read("data_draw_ms.train", rec) == pytest.approx(3.0)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_readers_are_silent_without_a_trace_or_their_spans(session, name):
    kind = "serve" if name in SERVE else "train"
    session(serve_session() if kind == "serve" else train_session())
    assert read(name, record(kind, traced=False)) is None
    assert read(name, record("train" if kind == "serve" else "serve")) \
        is None
    session({"spans": [], "counters": {}})
    assert read(name, record(kind)) is None
    other = train_session() if kind == "serve" else serve_session()
    session(other)
    assert read(name, record(kind)) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_readers_are_silent_in_a_program_without_the_recorder(
        monkeypatch, name):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    kind = "serve" if name in SERVE else "train"
    assert read(name, record(kind)) is None


def test_the_new_metrics_are_listed_for_the_cells_that_record_them():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SERVE + TRAIN:
        assert per[name]["source"] in ("program_span", "program_counter")
        want = (["glm4-9b.chat", "glm4-9b.long-prompt"] if name in SERVE
                else ["stablelm-3b.train"])
        assert per[name]["workloads"] == want
