"""Serving mechanics of the port (``repro_torch.serve.decode``) on the CPU,
on reduced glm4-9b in float32: the eager tests of
``tests/test_serve_continuous.py`` and ``tests/test_serve_decode.py`` that
``test_torch_serve.py`` does not already mirror, and the port's
``FixedBatchServer`` against the JAX one.

On converted parameters the port's ``FixedBatchServer`` serves the JAX
``FixedBatchServer``'s tokens, request for request, and the port's
``BatchedServer`` serves them for ragged prompt lengths (the JAX baseline
one slot at a time, where a shared decode position is exact).  The CUDA
graphs of ``BatchedServer`` run on the card only
(``tests/test_torch_serve_graphs.py``); on the CPU ``aot`` is off, and
asking for it raises.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.serve import FixedBatchServer as JFixedBatchServer
from repro_torch.configs import get_config
from repro_torch.core import get_case
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import BatchedServer, FixedBatchServer, generate


def reduced(get, arch="glm4-9b"):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model, JAX params) on the same parameters."""
    jm = jax_model(reduced(jax_config))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return tm, jm, jp


@pytest.fixture
def model(models):
    return models[0]


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    ops.telemetry.reset()
    yield
    ops.clear_all()
    ops.telemetry.reset()


def prompts(n, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, length).astype(np.int32) for _ in range(n)]


def ragged_prompts(n, seed=1, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def server(model, **kw):
    return BatchedServer(model, device="cpu", **kw)


def test_fixed_batch_server_matches_jax_fixed_batch_server(models):
    tm, jm, jp = models
    jsrv = JFixedBatchServer(jm, jp, slots=2, max_len=32, prompt_len=8)
    srv = FixedBatchServer(tm, slots=2, max_len=32, prompt_len=8,
                           device="cpu")
    ps = prompts(5)
    jreqs = [jsrv.submit(p, max_new=4) for p in ps]
    reqs = [srv.submit(p, max_new=4) for p in ps]
    jfin, fin = jsrv.run(), srv.run()
    assert [r.rid for r in fin] == [r.rid for r in jfin] == [0, 1, 2, 3, 4]
    for r, j in zip(reqs, jreqs):
        assert r.done and r.tokens == j.tokens, (r.rid, r.tokens, j.tokens)


def test_batched_server_matches_jax_fixed_batch_server_on_ragged_lengths(
        models):
    tm, jm, jp = models
    ps = ragged_prompts(5, seed=2)
    jsrv = JFixedBatchServer(jm, jp, slots=1, max_len=32)
    jreqs = [jsrv.submit(p, max_new=4) for p in ps]
    jsrv.run()
    srv = server(tm, slots=3, max_len=32)
    reqs = [srv.submit(p, max_new=4) for p in ps]
    srv.run()
    assert len({r.bucket for r in reqs}) > 1
    for r, j in zip(reqs, jreqs):
        assert r.done and r.tokens == j.tokens, (r.rid, r.tokens, j.tokens)


def test_fixed_batch_server_baseline_still_serves(model):
    srv = FixedBatchServer(model, slots=2, max_len=64, prompt_len=8,
                           device="cpu")
    reqs = [srv.submit(p, max_new=4) for p in prompts(5)]
    fin = srv.run()
    assert all(r.done and len(r.tokens) == 4 for r in reqs)
    assert [r.rid for r in fin] == [0, 1, 2, 3, 4]
    assert srv.swap_epochs == 0
    ops.install("attention", get_case("attention_prefill").build(
        {"chunked": True, "block_q": 64}))
    srv.submit(prompts(1)[0], max_new=2)
    srv.run()
    assert srv.swap_epochs == 1


def test_aot_is_off_on_the_cpu_and_refused_there(model):
    srv = server(model, slots=2, max_len=64)
    assert not srv.aot and srv.aot_compiles == 0 and srv.capture_s == 0.0
    with pytest.raises(ValueError, match="aot=True captures CUDA graphs"):
        server(model, slots=2, max_len=64, aot=True)
    jobs = ragged_prompts(5, seed=6)
    reqs = [srv.submit(p, max_new=4) for p in jobs]
    srv.run()
    for r, p in zip(reqs, jobs):
        want = [int(t) for t in generate(model, p[None], max_new=4,
                                         device="cpu")[0]]
        assert r.tokens == want
    assert srv.aot_compiles == 0


def test_a_failed_swap_capture_raises_again_and_nothing_serves_eagerly(
        model, monkeypatch):
    """The swap epoch counts as seen only once its capture succeeded, and a
    graph server's packed prefill without its graph raises instead of
    running eagerly.  A capture needs the card, so this server's capture
    is replaced by one that fails, then by one that captures nothing."""
    srv = server(model, slots=2, max_len=32)
    srv.aot = True                       # as on the card; capture replaced
    calls = []

    def failing_capture():
        calls.append(1)
        raise RuntimeError("CUDA graph capture of the decode step failed")

    monkeypatch.setattr(srv, "_capture_all", failing_capture)
    ops.install("attention", get_case("attention_prefill").build(
        {"chunked": True, "block_q": 64}))
    req = srv.submit(prompts(1)[0], max_new=3)
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            srv.step()
        assert len(calls) == n and srv.swap_epochs == 0
    monkeypatch.setattr(srv, "_capture_all", lambda: None)
    with pytest.raises(KeyError, match="prefill"):
        srv.step()
    assert srv.swap_epochs == 1 and req.tokens == []


def test_pending_queue_fifo_and_slot_recycling(model):
    srv = server(model, slots=2, max_len=32)
    reqs = [srv.submit(p, max_new=3) for p in prompts(5)]
    assert [r.rid for r in reqs] == [0, 1, 2, 3, 4]
    srv.step()
    assert [len(r.tokens) > 0 for r in reqs] == [True, True, False, False,
                                                False]
    finished = srv.run()
    assert all(r.done and len(r.tokens) == 3 for r in reqs)
    assert [r.rid for r in finished] == [0, 1, 2, 3, 4]


def test_slot_recycled_after_eos(model):
    probe = server(model, slots=1, max_len=32)
    r0 = probe.submit(prompts(1)[0], max_new=6)
    probe.run()
    eos = r0.tokens[1]

    srv = server(model, slots=1, max_len=32, eos_id=eos)
    a = srv.submit(prompts(1)[0], max_new=10)
    b = srv.submit(prompts(3)[2], max_new=2)
    srv.run()
    assert a.done and len(a.tokens) <= 2 and a.tokens[-1] == eos
    assert b.done


def test_telemetry_counts_match_tokens_decoded(model):
    tel = ops.Telemetry()
    srv = server(model, slots=2, max_len=32, telemetry=tel)
    reqs = [srv.submit(p, max_new=4) for p in prompts(3)]
    srv.run()
    assert all(r.done for r in reqs)
    decoded = sum(len(r.tokens) - 1 for r in reqs)
    assert tel.tokens("attention", "decode") == decoded
    assert tel.tokens("attention", "prefill") == sum(len(r.prompt)
                                                     for r in reqs)
    ws = tel.weighted_scale("attention")
    assert 8 <= ws <= 8 + 4


def test_hot_swap_epoch_does_not_disturb_in_flight_requests(model):
    control = server(model, slots=2, max_len=32)
    control_reqs = [control.submit(p, max_new=6) for p in prompts(4)]
    control.run()

    srv = server(model, slots=2, max_len=32)
    reqs = [srv.submit(p, max_new=6) for p in prompts(4)]
    srv.step()
    srv.step()
    assert srv.swap_epochs == 0
    case = get_case("attention_prefill")
    gen = ops.install("attention",
                      case.build(dict(case.baseline_variant, chunked=True)))
    assert gen > 0
    srv.step()
    assert srv.swap_epochs == 1
    srv.run()
    for r, c in zip(reqs, control_reqs):
        assert r.tokens == c.tokens, f"request {r.rid} diverged across swap"
    ops.rollback("attention")
    srv.submit(prompts(1)[0], max_new=2)
    srv.run()
    assert srv.swap_epochs == 2


def test_request_done_at_prefill_keeps_slot_free(model):
    srv = server(model, slots=1, max_len=32)
    a = srv.submit(prompts(1)[0], max_new=1)
    b = srv.submit(prompts(3)[1], max_new=2)
    srv.run()
    assert a.done and len(a.tokens) == 1
    assert b.done and len(b.tokens) == 2


def test_generate_honors_eos_id(model):
    batch = np.stack(prompts(2))
    free = generate(model, batch, max_new=8, device="cpu")
    assert free.shape == (2, 8)
    eos = int(free[0, 1])
    out = generate(model, batch, max_new=8, eos_id=eos, device="cpu")
    assert out.shape == (2, 8)
    row = list(out[0])
    stop = row.index(eos)
    assert stop <= 1
    np.testing.assert_array_equal(row[:stop], list(free[0])[:stop])
    assert all(t == eos for t in row[stop:])
    for b in range(out.shape[0]):
        if eos not in list(free[b]):
            np.testing.assert_array_equal(out[b], free[b])


def test_run_drains_queue_when_steps_only_admit_and_finish_at_prefill(model):
    srv = server(model, slots=1, max_len=32)
    reqs = [srv.submit(p, max_new=1) for p in prompts(5)]
    fin = srv.run()
    assert all(r.done and len(r.tokens) == 1 for r in reqs)
    assert [r.rid for r in fin] == [0, 1, 2, 3, 4]


def test_step_reports_work_and_idle(model):
    srv = server(model, slots=2, max_len=32)
    assert srv.step() == 0
    a = srv.submit(prompts(1)[0], max_new=3)
    assert srv.step() > 0
    srv.run()
    assert a.done
    assert srv.step() == 0


def test_bucket_telemetry_reaches_autotuner(model):
    tel = ops.Telemetry()
    srv = server(model, slots=2, max_len=64, telemetry=tel)
    short = [p[:4] for p in ragged_prompts(3, seed=7, lo=4)]  # bucket 8
    long = [np.resize(p, 14).astype(np.int32)                 # bucket 16
            for p in ragged_prompts(3, seed=8)]
    reqs = [srv.submit(p, max_new=3) for p in short + long]
    srv.run()
    assert all(r.done for r in reqs)
    by_bucket = tel.site_buckets("attention")
    assert set(by_bucket) == {8, 16}
    assert list(by_bucket) == sorted(by_bucket,
                                     key=by_bucket.get, reverse=True)
    assert tel.weighted_scale("attention", bucket=8) <= \
        tel.weighted_scale("attention", bucket=16)


def test_recurrent_family_uses_exact_length_packing(model):
    assert server(model, slots=2, max_len=64).padded_packing
    rwkv = get_model(reduced(get_config, "rwkv6-7b"), device="cpu")
    srv = server(rwkv, slots=2, max_len=64)
    assert not srv.padded_packing and srv.buckets == ()
    p = ragged_prompts(1, seed=9)[0]
    assert srv.bucket_of(len(p)) == len(p)


def test_jax_fixed_batch_server_shares_the_decode_position(models):
    """Both baselines decode every slot at the first live slot's position:
    equal-length prompts only.  On the same prompts the two packages'
    token streams agree even where the shared position misplaces a slot
    (prompts of 8 and 5 tokens in two slots)."""
    tm, jm, jp = models
    ps = [prompts(1)[0], prompts(1, length=5, seed=4)[0]]
    jsrv = JFixedBatchServer(jm, jp, slots=2, max_len=32)
    srv = FixedBatchServer(tm, slots=2, max_len=32, device="cpu")
    jreqs = [jsrv.submit(p, max_new=3) for p in ps]
    reqs = [srv.submit(p, max_new=3) for p in ps]
    jsrv.run()
    srv.run()
    assert [r.tokens for r in reqs] == [j.tokens for j in jreqs]
