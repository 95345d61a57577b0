"""The port's online autotune loop (``repro_torch.serve.autotune``,
``core.integrate.guarded_install``) on the CPU, on the analytic
``h100-model`` platform with reduced glm4-9b (float32) served eagerly.

The six tests of ``tests/test_serve_autotune.py`` on the port: traffic is
served → telemetry accumulates → a campaign finds a faster variant at the
observed scale → ``guarded_install`` hot-swaps its ``cuda`` build (K2's
wrapper, its plain version on CPU tensors) without disturbing in-flight
requests → a faulty variant is refused and a regressing one rolled back.
Then parity with the JAX package: ``snap_scale``, ``bucket_key`` and
``split_bucket_key`` over a grid; ``GuardedInstall.to_dict()`` keys and
reason prefixes under the same scripted probes; the autotune journal
records' keys.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core import EvalCache as JEvalCache
from repro.core import MEPConstraints as JMEPConstraints
from repro.core import OptConfig as JOptConfig
from repro.core import ResultsDB as JResultsDB
from repro.core import TPUModelPlatform
from repro.core import get_case as jget_case
from repro.core.integrate import guarded_install as jguarded_install
from repro.kernels import ops as jops
from repro.serve import autotune as jat
from repro_torch.configs import get_config
from repro_torch.core import (EvalCache, H100ModelPlatform, MEPConstraints,
                              OptConfig, PatternStore, ResultsDB, get_case)
from repro_torch.core.integrate import guarded_install
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serve import (AutotuneConfig, BatchedServer, ServeAutotuner,
                               bucket_key, snap_scale, split_bucket_key)

FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
FAST_CFG = OptConfig(d_rounds=2, n_candidates=3, r=5, k=1)


@pytest.fixture(autouse=True)
def _clean_registry():
    for reg in (ops, jops):
        reg.clear_all()
        reg.telemetry.reset()
    yield
    for reg in (ops, jops):
        reg.clear_all()
        reg.telemetry.reset()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32")
    m = get_model(cfg, device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    return m


def prompts(n, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, length).astype(np.int32) for _ in range(n)]


def make_server(model, **kw):
    return BatchedServer(model, device="cpu", **kw)


def make_autotuner(db=None, **cfg_kw):
    cfg_kw.setdefault("min_tokens", 1)
    cfg_kw.setdefault("opt", FAST_CFG)
    cfg_kw.setdefault("constraints", FAST)
    cfg_kw.setdefault("probe_r", 2)
    cfg_kw.setdefault("probe_k", 0)
    # the campaign metric is the analytic H100 model but the guard probe
    # wall-clocks real CPU execution; be lenient about CPU-side noise
    cfg_kw.setdefault("max_regression", 20.0)
    cfg_kw.setdefault("interval_s", 0.05)
    return ServeAutotuner(H100ModelPlatform(device="cpu"),
                          config=AutotuneConfig(**cfg_kw),
                          cache=EvalCache(), db=db)


def test_config_patterns_knob_opens_persistent_store(tmp_path):
    path = str(tmp_path / "pat.jsonl")
    tuner = make_autotuner(patterns=path)
    assert tuner.patterns is not None and tuner.patterns.path == path
    mine = PatternStore()
    tuner2 = ServeAutotuner(H100ModelPlatform(device="cpu"),
                            config=AutotuneConfig(patterns=path),
                            cache=EvalCache(), patterns=mine)
    assert tuner2.patterns is mine


def test_snap_scale_picks_nearest_supported():
    case = get_case("attention_prefill")         # scales (256, ..., 2048)
    assert snap_scale(case, 12) == 256
    assert snap_scale(case, 700) == 512
    assert snap_scale(case, 4000) == 2048


@pytest.mark.parametrize("name", ["attention_prefill", "rwkv_wkv",
                                  "mamba_ssd"])
def test_scale_snapping_and_bucket_keys_equal_jax(name):
    case, jcase = get_case(name), jget_case(name)
    assert case.scales == jcase.scales
    for observed in list(range(0, 80, 7)) + list(range(100, 4200, 97)) + [
            384, 768, 1536]:
        assert snap_scale(case, observed) == jat.snap_scale(jcase, observed)
    for site in ("attention", "rwkv_wkv", "ssm_chunk", "a@b", "x@bq"):
        for b in (None, 0, 8, 256):
            key = bucket_key(site, b)
            assert key == jat.bucket_key(site, b)
            assert split_bucket_key(key) == jat.split_bucket_key(key)
    for key in ("attention@b", "attention@b8x", "@b16", "plain"):
        assert split_bucket_key(key) == jat.split_bucket_key(key)


def test_autotune_end_to_end_swap_and_rollback(model, tmp_path):
    db = ResultsDB(str(tmp_path / "autotune.jsonl"))

    # ---- control: the same workload served untouched, for comparison ----
    control = make_server(model, slots=2, max_len=32)
    control_reqs = [control.submit(p, max_new=6) for p in prompts(4)]
    control.run()

    # ---- 1. serve traffic: telemetry accumulates at the attention site --
    srv = make_server(model, slots=2, max_len=32)
    reqs = [srv.submit(p, max_new=6) for p in prompts(4)]
    srv.step()
    srv.step()                     # requests in flight, partially decoded
    assert ops.telemetry.tokens("attention") > 0

    # ---- 2. campaign over the observed hotspot at the observed scale ----
    tuner = make_autotuner(db=db)
    rep = tuner.run_once()
    assert rep.hot == {"attention@b8": 256}
    assert len(rep.results) == 1
    res = rep.results[0]
    assert res.speedup > 1.01                    # found a faster variant
    assert res.best_variant != res.baseline_variant

    # ---- 3. winner hot-swapped through guarded_install ------------------
    assert len(rep.installed) == 1
    swap = rep.installed[0]
    assert swap.site == "attention" and swap.fe_ok and swap.active
    gen_winner = ops.generation("attention")
    assert gen_winner == swap.generation > 0
    entry = ops.active_entry("attention")
    assert entry.info["variant"] == res.best_variant
    assert entry.info["impl"] == "cuda"          # the build timed on h100

    # ---- 4. serving picks up the swap without interrupting in-flight ----
    srv.step()
    assert srv.swap_epochs == 1
    srv.run()
    assert all(r.done for r in reqs)
    for r, c in zip(reqs, control_reqs):
        assert r.tokens == c.tokens, f"request {r.rid} diverged across swap"
    post = srv.submit(prompts(1)[0], max_new=4)
    srv.run()
    assert post.done and post.tokens == control_reqs[0].tokens[:4]

    # ---- 5a. injected faulty variant: FE gate keeps it out --------------
    case = get_case("attention_prefill")

    def faulty_build(variant, impl="torch"):
        real = case.build(variant, impl=impl)
        if variant.get("faulty"):
            return lambda q, k, v, causal=True, softcap=0.0: \
                real(q, k, v) * 1e3
        return real

    faulty_case = dataclasses.replace(case, build=faulty_build)
    bad = guarded_install(faulty_case, dict(case.baseline_variant,
                                            faulty=True), scale=256,
                          device="cpu")
    assert not bad.installed and bad.reason.startswith("fe_fail")
    assert ops.generation("attention") == gen_winner

    # ---- 5b. injected regressing variant: installed, then rolled back ---
    fn_winner = ops.get_impl("attention")

    def probe():                   # integrated step: slow iff swapped again
        time.sleep(0.02 if ops.generation("attention") > gen_winner
                   else 0.001)
        return np.zeros(2)

    worse = guarded_install(case, dict(case.baseline_variant), scale=256,
                            probe=probe, max_regression=0.5, r=2, k=0,
                            device="cpu")
    assert worse.installed and worse.rolled_back
    assert worse.reason.startswith("regressed")
    assert ops.generation("attention") == gen_winner
    assert ops.get_impl("attention") is fn_winner

    # ---- journal captured the loop --------------------------------------
    kinds = [r["kind"] for r in db.records()]
    assert "autotune_cycle" in kinds and "autotune_swap" in kinds
    cyc = next(db.records("autotune_cycle"))
    assert cyc["hot"] == {"attention@b8": 256}
    assert cyc["swaps"] and cyc["swaps"][0]["active"]

    late = srv.submit(prompts(1)[0], max_new=3)
    srv.run()
    assert late.done


def test_second_cycle_is_noop_until_traffic_shifts(model):
    srv = make_server(model, slots=2, max_len=32)
    for p in prompts(3):
        srv.submit(p, max_new=4)
    srv.run()
    tuner = make_autotuner()
    rep1 = tuner.run_once()
    assert rep1.hot and rep1.results
    rep2 = tuner.run_once()
    assert rep2.hot == {} and rep2.skipped
    assert tuner.tuned_scales == {"attention@b8": 256}


def test_background_thread_start_stop():
    tuner = make_autotuner()       # no traffic: cycles skip instantly
    th = tuner.start()
    assert th is tuner.start()     # idempotent
    deadline = time.time() + 5.0
    while not tuner.reports and time.time() < deadline:
        time.sleep(0.01)
    assert tuner.reports and tuner.reports[0].skipped
    tuner.stop()
    assert not th.is_alive()


def test_stop_event_interrupts_campaign_mid_flight(model):
    srv = make_server(model, slots=2, max_len=32)
    for p in prompts(3):
        srv.submit(p, max_new=4)
    srv.run()
    tuner = make_autotuner(opt=OptConfig(d_rounds=8, n_candidates=3,
                                         r=5, k=1), install=True)
    tuner._stop.set()              # stop requested before the cycle
    rep = tuner.run_once()
    assert rep.results and rep.results[0].stop_reason == "stop requested"
    assert rep.swaps == []         # no install on a stopped cycle
    assert not tuner.tuned_scales


def test_out_of_process_executors_wait_for_the_fabric(model, tmp_path,
                                                      monkeypatch):
    """The fabric has come: with ``executor="local-cluster"`` a cycle's
    campaign runs in a worker process (one CPU thread) and finds the
    in-process tuner's winner, ``guarded_install`` installs it in the
    serving process, and ``stop`` closes the tuner's fabric."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    srv = make_server(model, slots=2, max_len=32)
    for p in prompts(4):
        srv.submit(p, max_new=6)
    srv.step()
    srv.step()
    ref = make_autotuner(install=False).run_once()
    tuner = ServeAutotuner(
        H100ModelPlatform(device="cpu"),
        config=AutotuneConfig(executor="local-cluster", workers=1,
                              min_tokens=1, opt=FAST_CFG, constraints=FAST,
                              probe_r=2, probe_k=0, max_regression=20.0,
                              interval_s=0.05),
        cache=EvalCache(str(tmp_path / "ec.jsonl")),
        db=ResultsDB(str(tmp_path / "autotune.jsonl")))
    try:
        rep = tuner.run_once()
        procs = dict(tuner._executor._procs)
        assert procs and all(w.alive() for w in procs.values())
    finally:
        tuner.stop()
    assert not any(w.alive() for w in procs.values())
    assert rep.hot == ref.hot == {"attention@b8": 256}
    (res,), (want,) = rep.results, ref.results
    assert res.best_variant == want.best_variant != res.baseline_variant
    assert res.best_time_s == want.best_time_s
    assert len(rep.installed) == 1 and rep.installed[0].fe_ok
    assert ops.active_entry("attention").info["variant"] == res.best_variant
    starts = list(tuner.db.records("campaign_start"))
    assert starts and starts[0]["executor"] == "local-cluster"


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
def scripted(generation, outcome):
    """A probe scripted by ``outcome``; ``generation()`` reads the site's
    registry generation, 0 before the install.  The regressing probe is
    250x slower once installed, far beyond ``max_regression`` (20) and the
    CPU's timing noise under parallel test workers; the others keep one
    time."""
    def probe():
        after = generation() > 0
        time.sleep(0.5 if outcome == "regressed" and after else 0.002)
        if outcome == "probe_error" and after:
            raise RuntimeError("scripted probe failure")
        if outcome == "probe_error(baseline)":
            raise RuntimeError("scripted baseline failure")
        return np.ones(2) if outcome == "diverged" and after else np.zeros(2)
    return probe


def faulty(case, scale_by):
    def build(variant, impl):
        real = case.build(variant, impl=impl)
        return lambda q, k, v, causal=True, softcap=0.0: \
            real(q, k, v) * scale_by
    return dataclasses.replace(case, build=build)


@pytest.mark.parametrize("outcome", ["installed", "fe_fail", "regressed",
                                     "diverged", "probe_error",
                                     "probe_error(baseline)"])
def test_guarded_install_outcomes_equal_jax(outcome):
    case, jcase = get_case("attention_prefill"), jget_case("attention_prefill")
    variant = dict(case.baseline_variant, chunked=True)
    if outcome == "fe_fail":
        case, jcase = faulty(case, 1e3), faulty(jcase, 1e3)
    kw = dict(scale=256, max_regression=20.0, r=2, k=0)
    got = guarded_install(
        case, variant, probe=scripted(lambda: ops.generation("attention"),
                                      outcome), device="cpu", **kw)
    want = jguarded_install(
        jcase, variant, probe=scripted(lambda: jops.generation("attention"),
                                       outcome), **kw)
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    assert g["reason"].split(":")[0] == w["reason"].split(":")[0]
    assert g["reason"].split(":")[0] == outcome
    for key in ("site", "case", "variant", "scale", "installed",
                "rolled_back", "active", "fe_ok", "generation_before"):
        assert g[key] == w[key], key
    # generations come from each registry's own process-wide counter:
    # compare what they say, a live install or the prior state
    assert (g["generation"] > g["generation_before"]) == \
        (w["generation"] > w["generation_before"]) == g["active"]
    assert ops.generation("attention") == g["generation"]
    assert jops.generation("attention") == w["generation"]


def test_autotune_journal_records_equal_jax(tmp_path):
    """One cycle of each package's autotuner over the same telemetry (the
    attention site, bucket 8, at context 8): the same record kinds, the
    same keys in the cycle and swap records and in each swap."""
    tel, jtel = ops.Telemetry(), jops.Telemetry()
    for t in (tel, jtel):
        t.observe("attention", scale=8, tokens=300, kind="prefill", bucket=8)
    db = ResultsDB(str(tmp_path / "port.jsonl"))
    jdb = JResultsDB(str(tmp_path / "jax.jsonl"))
    cfg = dict(min_tokens=1, probe_r=2, probe_k=0, max_regression=20.0)
    tuner = ServeAutotuner(
        H100ModelPlatform(device="cpu"), telemetry=tel, cache=EvalCache(),
        db=db, config=AutotuneConfig(opt=FAST_CFG, constraints=FAST, **cfg))
    jtuner = jat.ServeAutotuner(
        TPUModelPlatform(), telemetry=jtel, cache=JEvalCache(), db=jdb,
        config=jat.AutotuneConfig(
            opt=JOptConfig(d_rounds=2, n_candidates=3, r=5, k=1),
            constraints=JMEPConstraints(t_max_s=2.0, r=5, k=1), **cfg))
    rep, jrep = tuner.run_once(), jtuner.run_once()
    assert rep.hot == jrep.hot == {"attention@b8": 256}
    assert [s.active for s in rep.swaps] == [s.active for s in jrep.swaps] \
        == [True]
    for kind in ("autotune_cycle", "autotune_swap"):
        [rec], [jrec] = list(db.records(kind)), list(jdb.records(kind))
        assert sorted(rec) == sorted(jrec), kind
    cyc, jcyc = next(db.records("autotune_cycle")), \
        next(jdb.records("autotune_cycle"))
    assert sorted(cyc["swaps"][0]) == sorted(jcyc["swaps"][0])
    assert cyc["swaps"][0]["reason"] == jcyc["swaps"][0]["reason"] \
        == "installed"
    # a failing cycle journals autotune_error in both packages
    for t, d in ((tuner, db), (jtuner, jdb)):
        t.site_cases = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
        t.tuned_scales.clear()
        t._stop.clear()
        th = t.start()
        deadline = time.time() + 10.0
        while not list(d.records("autotune_error")) \
                and time.time() < deadline:
            time.sleep(0.01)
        t.stop()
        assert not th.is_alive()
    [err], [jerr] = list(db.records("autotune_error")), \
        list(jdb.records("autotune_error"))
    assert sorted(err) == sorted(jerr) and err["error"] == jerr["error"] \
        == "RuntimeError: boom"
