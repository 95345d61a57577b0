"""The port's span and counter recorder (``repro_torch.tracing``) and the
paths it instruments.

* off, nothing is recorded and ``span`` hands out the shared null context;
  on under ``torch.profiler`` and inside ``recording()``;
* parents from a stack per thread; ``begin``/``end`` across calls;
  counters; self time; a new session drops the old one;
* the idle split over hand-made device intervals;
* ``BatchedServer(aot=False)`` on reduced glm4-9b serves the same tokens
  recorded and not, with its steps' spans nested as the server runs them
  and the prefill counters equal to the prompts' tokens and the padded
  positions; ``make_train_step(accum=2)`` gives the same losses and
  parameters, bit for bit, with its phases' spans under ``train.step``;
* on a card (marked ``cuda``; skipped without one): device intervals open
  after their host spans, and no event under graph capture.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.models import get_model
from repro_torch.serve import BatchedServer
from repro_torch.train.optim import AdamWConfig, init_state
from repro_torch.train.steps import make_train_step, model_params


def names(sess):
    return [s["name"] for s in sess["spans"]]


def test_off_records_nothing_and_hands_out_the_shared_null():
    with tracing.recording():
        with tracing.span("kept"):
            pass
    with tracing.span("dropped") as sp:
        sp.set(a=1)
    assert tracing.span("dropped", torch.device("cpu"), x=1) is tracing.NULL
    assert tracing.begin("dropped") is None
    tracing.count("dropped")
    # the read was made off: what the block recorded is still there
    assert names(tracing.session()) == ["kept"]
    assert tracing.session()["counters"] == {}


def test_records_under_the_profiler_and_under_recording():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled", k=1) as sp:
            sp.set(later=2)
    sess = tracing.session()
    assert names(sess) == ["profiled"]
    assert sess["spans"][0]["attrs"] == {"k": 1, "later": 2}
    assert sess["spans"][0]["device"] is None
    with tracing.recording():
        with tracing.span("recorded", torch.device("cpu")):
            pass
    (s,) = tracing.session()["spans"]
    assert s["name"] == "recorded" and s["device"] is None
    assert s["t0"] <= s["t1"] and s["nested"] and not s["captured"]


def test_parents_follow_a_stack_of_each_thread():
    started, release = threading.Event(), threading.Event()

    def other():
        with tracing.span("t.outer"):
            started.set()
            release.wait(10)
            with tracing.span("t.inner"):
                pass

    with tracing.recording():
        th = threading.Thread(target=other)
        with tracing.span("outer"):
            th.start()
            assert started.wait(10)
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    release.set()
            th.join(10)
        assert not th.is_alive()
    sess = tracing.session()
    by = {s["name"]: s for s in sess["spans"]}
    assert by["outer"]["parent"] is None and by["t.outer"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["leaf"]["parent"] == by["inner"]["id"]
    assert by["t.inner"]["parent"] == by["t.outer"]["id"]
    assert by["t.inner"]["thread"] != by["inner"]["thread"]
    assert [s["name"] for s in tracing.within(sess, by["outer"])] == \
        ["inner", "leaf"]


def test_begin_and_end_span_calls_and_parent_nothing():
    with tracing.recording():
        with tracing.span("step"):
            sid = tracing.begin("queue", rid=7)
        with tracing.span("later"):
            pass
        open_sid = tracing.begin("never ended")
        tracing.end(sid)
        tracing.end(None)
        tracing.end(10 ** 9)              # no such span: nothing
    sess = tracing.session()
    by = {s["name"]: s for s in sess["spans"]}
    assert set(by) == {"step", "later", "queue"}
    assert open_sid is not None
    assert by["queue"]["parent"] == by["step"]["id"]
    assert by["queue"]["attrs"] == {"rid": 7} and not by["queue"]["nested"]
    assert by["later"]["parent"] is None
    assert by["queue"]["t1"] >= by["later"]["t1"]


def test_counters_add_while_recording():
    tracing.count("c", 100)                # off
    with tracing.recording():
        tracing.count("c")
        tracing.count("c", 4)
        tracing.count("d", 2)
    tracing.count("c", 100)                # off again
    assert tracing.session()["counters"] == {"c": 5, "d": 2}


def span_of(name, sid, parent, t0, t1, device=None, nested=True):
    return {"name": name, "id": sid, "parent": parent, "thread": 1,
            "attrs": {}, "nested": nested, "t0": t0, "t1": t1,
            "device": device, "captured": False}


def test_self_time_is_the_duration_less_what_children_cover():
    ms = 1_000_000
    sess = {"spans": [span_of("p", 0, None, 0, 10 * ms),
                      span_of("a", 1, 0, 1 * ms, 4 * ms),
                      span_of("b", 2, 0, 3 * ms, 5 * ms),   # overlaps a
                      span_of("g", 3, 1, 1 * ms, 2 * ms),   # a grandchild
                      span_of("x", 4, None, 2 * ms, 20 * ms)],
            "counters": {}}
    p = sess["spans"][0]
    assert tracing.host_ms(p) == pytest.approx(10.0)
    assert tracing.self_ms(sess, p) == pytest.approx(10.0 - 4.0)
    assert tracing.self_ms(sess, sess["spans"][1]) == pytest.approx(2.0)
    t = tracing.totals(sess)
    assert t["p"] == {"n": 1, "host_ms": pytest.approx(10.0), "device_n": 0,
                      "device_ms": 0.0}


def test_a_new_session_drops_the_old_one():
    from torch.profiler import ProfilerActivity, profile
    with tracing.recording():
        with tracing.span("first"):
            pass
        tracing.count("n")
    with tracing.recording():
        with tracing.span("second"):
            pass
    assert names(tracing.session()) == ["second"]
    assert tracing.session()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("third"):
            pass
    assert names(tracing.session()) == ["third"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("fourth"):       # after a read made off
            pass
    assert names(tracing.session()) == ["fourth"]


def test_idle_split_divides_gaps_across_innermost_host_spans():
    # device busy [0, 10) and [30, 40) and [50, 60); host: a step [5, 45)
    # holding a commit [12, 20); nothing over [45, 50); a queue span
    # (begin/end) over everything is no one's work
    sess = {"spans": [
        span_of("dev1", 0, 1, 1, 9, device=[0, 10]),
        span_of("step", 1, None, 5, 45),
        span_of("commit", 2, 1, 12, 20),
        span_of("dev2", 3, 1, 30, 31, device=[30, 40]),
        span_of("dev3", 4, None, 50, 51, device=[50, 60]),
        span_of("queue", 5, None, 0, 60, nested=False)], "counters": {}}
    split = tracing.idle_split(sess)
    assert split["window_ns"] == 60 and split["busy_ns"] == 30
    # gap [10, 30): step 10-12, commit 12-20, step 20-30; gap [40, 50):
    # step 40-45, outside 45-50
    assert split["idle"] == {"step": 2 + 10 + 5, "commit": 8,
                             tracing.OUTSIDE: 5}
    assert split["under"] == {"step": 25, "commit": 8}
    assert sum(split["idle"].values()) == 60 - 30
    assert tracing.idle_split({"spans": sess["spans"][1:3],
                               "counters": {}}) is None


# ------------------------------------------------------ instrumented paths --
def tiny_model():
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    return model


def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (3, 20, 9, 14, 5, 9)]


def serve(model, ps):
    srv = BatchedServer(model, slots=4, max_len=64, aot=False, device="cpu")
    reqs = [srv.submit(p, max_new=4) for p in ps]
    srv.run()
    return srv, [r.tokens for r in reqs], [r.rid for r in reqs]


def test_the_server_serves_the_same_tokens_recorded_and_its_spans_nest():
    model, ps = tiny_model(), prompts()
    _, plain, _ = serve(model, ps)
    with tracing.recording():
        srv, traced, rids = serve(model, ps)
    assert traced == plain
    sess = tracing.session()
    steps = tracing.named(sess, "serve.step")
    assert steps and all(s["parent"] is None for s in steps)
    decode_only = [s for s in steps if not any(
        t["name"] == "serve.prefill" for t in tracing.within(sess, s))]
    assert decode_only
    for s in decode_only:
        kids = [t["name"] for t in sess["spans"] if t["parent"] == s["id"]]
        assert kids == ["serve.inputs", "serve.replay", "serve.readback",
                        "serve.commit"]
        assert s["attrs"]["admitted"] == 0 and s["attrs"]["live"] > 0
    # admission: one serve.prefill a bucket of a wave, listing its rids
    prefills = tracing.named(sess, "serve.prefill")
    listed = [rid for p in prefills for rid in p["attrs"]["rids"]]
    assert sorted(listed) == sorted(rids)
    for p in prefills:
        kids = [t for t in sess["spans"] if t["parent"] == p["id"]]
        assert [t["name"] for t in kids] == [
            "serve.inputs", "serve.replay", "serve.inputs", "serve.splice",
            "serve.readback"]
        assert kids[1]["attrs"]["graph"] == \
            f"prefill/{p['attrs']['bucket']}/{p['attrs']['padded_rows']}"
        assert p["attrs"]["padded_rows"] >= p["attrs"]["rows"] \
            == len(p["attrs"]["rids"])
        assert p["attrs"]["bucket"] in srv.buckets
    assert sess["counters"] == {
        "serve.prefill_tokens": sum(len(p) for p in ps),
        "serve.prefill_positions": sum(p["attrs"]["bucket"]
                                       * p["attrs"]["padded_rows"]
                                       for p in prefills)}
    # each request waited from its submission to its bucket's prefill
    queue = {q["attrs"]["rid"]: q for q in tracing.named(sess, "serve.queue")}
    assert sorted(queue) == sorted(rids)
    for p in prefills:
        for rid in p["attrs"]["rids"]:
            assert queue[rid]["t0"] <= queue[rid]["t1"]
            assert p["t0"] <= queue[rid]["t1"] <= p["t1"]
            assert queue[rid]["attrs"]["prompt_len"] == \
                len(ps[rids.index(rid)])


def train_run(model, steps=2):
    params = model_params(model)
    state = init_state(params)
    step = make_train_step(model, AdamWConfig(lr=1e-3), accum=2)
    data = SyntheticLMData(model.cfg, 16, 4, seed=5)
    losses = []
    for s in range(steps):
        params, state, m = step(params, state,
                                make_global_batch(data, s, device="cpu"))
        losses.append(m["loss"].clone())
    return losses, {n: p.detach().clone() for n, p in params.items()}


def test_the_train_step_is_bit_equal_recorded_and_holds_its_phases():
    plain = train_run(tiny_model())
    with tracing.recording():
        traced = train_run(tiny_model())
    assert all(torch.equal(a, b) for a, b in zip(plain[0], traced[0]))
    assert plain[1].keys() == traced[1].keys()
    assert all(torch.equal(plain[1][n], traced[1][n]) for n in plain[1])
    sess = tracing.session()
    steps = tracing.named(sess, "train.step")
    assert len(steps) == 2 and all(s["attrs"] == {"accum": 2} for s in steps)
    for s in steps:
        kids = [(t["name"], t["attrs"].get("micro")) for t in sess["spans"]
                if t["parent"] == s["id"]]
        assert kids == [("train.forward", 0), ("train.backward", 0),
                        ("train.forward", 1), ("train.backward", 1),
                        ("train.update", None)]
    draws = tracing.named(sess, "data.draw")
    copies = tracing.named(sess, "data.copy")
    assert [d["attrs"]["rows"] for d in draws] == [4, 4]
    assert [c["attrs"]["bytes"] for c in copies] == [2 * 4 * 16 * 4] * 2
    assert all(d["parent"] is None for d in draws + copies)


# ------------------------------------------------------------------ card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events and graph capture)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_intervals_follow_their_host_spans_and_skip_capture(card):
    x = torch.randn(2048, 2048, device=card)
    with tracing.recording():
        with tracing.span("host.outer"):
            with tracing.span("mm", card) as sp:
                for _ in range(20):
                    x = torch.tanh(x @ x)
            time.sleep(0.001)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            y = x + 1                          # warm-up off the graph
            with torch.cuda.graph(graph, stream=stream):
                with tracing.span("captured", card):
                    y = x + 1
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
    assert sp.captured is False
    sess = tracing.session()
    by = {s["name"]: s for s in sess["spans"]}
    mm = by["mm"]
    assert mm["device"] is not None
    d0, d1 = mm["device"]
    assert mm["t0"] <= d0 < d1
    assert tracing.device_ms(mm) > 0
    assert by["captured"]["captured"] and by["captured"]["device"] is None
    assert by["host.outer"]["device"] is None
    split = tracing.idle_split(sess)
    assert split["busy_ns"] == d1 - d0 and split["window_ns"] == d1 - d0
    del y
