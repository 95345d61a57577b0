"""The port's chaos harness on the CPU: scripted fault injection against
the fleet's fault-tolerance layer (reconnect/backoff, host quarantine and
readmission, replication-safe compaction).

Mirrors ``tests/test_chaos.py`` on the analytic ``h100-model``
(``device="cpu"``).  The slow leg: a two-"host" loopback spawn fleet runs
a campaign while a scripted ``FaultPlan`` kills one host's server
mid-campaign and tears another reply mid-line, and a replicated
``PatternStore`` is force-compacted between batches; the winners equal a
fault-free run's, with the quarantine / readmission / reroute transitions
journaled.  Then the wire against the JAX package's: ``backoff_schedule``
at the same arguments, and a ``FaultPlan`` written by JAX's ``to_env``.
"""
import json
import os

import pytest

from repro_torch.core import (Campaign, CaseJob, ChaosInjector, EvalCache,
                              EvalRecord, Fault, FaultPlan, FleetHost,
                              H100ModelPlatform, HeuristicProposer,
                              InProcessExecutor, JournalLink,
                              MEPConstraints, OptConfig, OptResult,
                              PatternStore, RemoteExecutor, Replicator,
                              ResultsDB, WorkerContext, WorkerFault,
                              backoff_schedule, canonical_spec, get_case)
from repro_torch.core.chaos import CHAOS_ENV, _spec_label
from repro_torch.core.evalcache import marker_epoch
from repro_torch.core.workers import _ConnectError, _SocketWorker


@pytest.fixture(autouse=True, scope="module")
def _one_thread_workers():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def model_platform():
    return H100ModelPlatform(device="cpu")


FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
# ppi=False: record-only pattern inheritance, so winners are identical
# whether a hint-producing job ran before or after a fault-induced retry
CHAOS_CFG = OptConfig(d_rounds=2, n_candidates=2, r=5, k=1, ppi=False)

CASES = ("atax", "bicg", "gemm", "gesummv")


def _jobs():
    return [CaseJob(get_case(n), HeuristicProposer(0, platform="h100-model"),
                    cfg=CHAOS_CFG,
                    constraints=FAST) for n in CASES]


def _winners(results):
    return [(r.case_name, r.best_variant, round(r.best_time_s, 12))
            for r in results]


def _spec(case="gemm", label=""):
    return {"job": {"label": label, "case": {"name": case}}}


# ----------------------------------------------------- plan plumbing -----
def test_fault_plan_roundtrips_through_env():
    plan = FaultPlan([Fault("kill_server", match="gemm", at_nth=2),
                      Fault("stall", sleep_s=1.5, host="fleetB")])
    env = plan.to_env({})
    back = FaultPlan.from_env(env)
    assert back is not None and back.faults == plan.faults
    assert FaultPlan.from_env({}) is None
    assert ChaosInjector.from_env({}) is None
    assert ChaosInjector.from_env({CHAOS_ENV: "[]"}) is None


def test_fault_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("set-on-fire")


def test_injector_matching_at_nth_and_ping_immunity(tmp_path):
    inj = ChaosInjector(FaultPlan([
        Fault("drop_connection", match="gemm", at_nth=2)]))
    # pings never count, whatever their shape
    assert inj.fire({"ping": True}) == []
    assert inj.fire(_spec("gemm")) == []          # 1st match: not yet
    assert inj.fire(_spec("atax")) == []          # non-match: no count
    drops = inj.fire(_spec("gemm"))               # 2nd match: due
    assert len(drops) == 1 and drops[0].kind == "drop_connection"
    assert inj.fire(_spec("gemm")) == []          # fired once, stays done


def test_injector_host_filter_and_flag_latch(tmp_path, monkeypatch):
    flag = str(tmp_path / "once.flag")
    inj = ChaosInjector(FaultPlan([
        Fault("drop_connection", host="fleetB", flag=flag)]))
    monkeypatch.setenv("REPRO_HOST_ALIAS", "fleetA")
    assert inj.fire(_spec()) == []                # wrong host: no count
    monkeypatch.setenv("REPRO_HOST_ALIAS", "fleetB")
    assert len(inj.fire(_spec())) == 1
    assert os.path.exists(flag)                   # latch acquired
    # a fresh injector (simulating a respawned server) honors the latch
    inj2 = ChaosInjector(FaultPlan([
        Fault("drop_connection", host="fleetB", flag=flag)]))
    assert inj2.fire(_spec()) == []


def test_injector_corrupt_journal_poisons_file(tmp_path):
    path = str(tmp_path / "pat.jsonl")
    inj = ChaosInjector(FaultPlan([
        Fault("corrupt_journal", path=path, payload="CHAOS not-json {")]))
    assert inj.fire(_spec()) == []
    with open(path) as f:
        assert f.read() == "CHAOS not-json {\n"
    # the store quarantines the poisoned journal instead of crashing
    with pytest.warns(RuntimeWarning, match="quarantined"):
        s = PatternStore(path)
    assert len(s) == 0 and s.quarantined == 1


def test_spec_label_covers_label_and_case():
    assert _spec_label({"job": {"label": "L1",
                                "case": {"name": "gemm"}}}) == "L1|gemm"
    assert _spec_label({}) == "|"


# ------------------------------------------------- reconnect/backoff -----
def test_backoff_schedule_is_deterministic_and_capped():
    assert backoff_schedule(0.05, 2.0, 6) == [0.05, 0.1, 0.2, 0.4, 0.8,
                                              1.6]
    assert backoff_schedule(1.0, 4.0, 5) == [1.0, 2.0, 4.0, 4.0, 4.0]
    assert backoff_schedule(1.0, 4.0, 0) == []
    # deterministic: two calls agree exactly (jitter-free on purpose)
    assert backoff_schedule(0.3, 9.0, 8) == backoff_schedule(0.3, 9.0, 8)


def test_socket_worker_connect_is_bounded_and_typed():
    # a refused port fails fast as _ConnectError, not a generic OSError
    with pytest.raises(_ConnectError):
        _SocketWorker("127.0.0.1:1", ("x", 0), connect_timeout_s=2.0)


def test_unreachable_socket_host_surfaces_connect_workerfault():
    """A standing-server host that is down yields
    ``WorkerFault(kind="connect")`` after the backoff schedule — the
    fault taxonomy's new third kind, distinct from crash/timeout."""
    ex = RemoteExecutor(
        [{"name": "deadhost", "transport": "socket",
          "address": "127.0.0.1:1", "connect_timeout_s": 1.0}],
        retries=0, backoff_base_s=0.01, backoff_max_s=0.02,
        backoff_attempts=1)
    ctx = WorkerContext(platform=model_platform())
    try:
        out = ex.run(_jobs()[:1], ctx, campaign_id="dead")
    finally:
        ex.close()
    assert len(out) == 1 and isinstance(out[0], WorkerFault)
    assert out[0].kind == "connect"


def test_spawn_server_killed_between_campaigns_is_respawned(tmp_path):
    """Reconnect path without any chaos env: kill a spawn host's server
    between two run() calls — the next dispatch reconnects (respawning
    the server) instead of failing the campaign."""
    ex = RemoteExecutor([{"name": "bounce"}], retries=1,
                        backoff_base_s=0.05, backoff_max_s=0.4,
                        backoff_attempts=4)
    cache = EvalCache(str(tmp_path / "cache.jsonl"))
    ctx = WorkerContext(platform=model_platform(), cache=cache)
    try:
        r1 = ex.run(_jobs()[:1], ctx, campaign_id="c1")
        assert isinstance(r1[0], OptResult)
        ex._servers["bounce"].kill()           # the "host" reboots
        r2 = ex.run(_jobs()[:1], ctx, campaign_id="c2")
        assert isinstance(r2[0], OptResult)
        assert _winners(r1) == _winners(r2)
        assert ex.fleet_events()["reconnects"] >= 1
    finally:
        ex.close()


# ------------------------------------- replication-safe compaction -------
def _lines(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln.strip()]


def _payload_lines(path):
    return [ln for ln in _lines(path) if marker_epoch(ln) is None]


def _record_patterns(store, n, start=0):
    base = {"block_m": 64, "block_n": 64}
    for i in range(start, start + n):
        store.record(get_case("gemm"), "tpu", base,
                     dict(base, block_m=128 + 8 * i), 1.5 + i)


def test_tail_survives_pattern_store_compaction(tmp_path):
    """The tentpole's third pillar at unit scale: a PatternStore that is
    a live replication endpoint compacts (os.replace inode swap) — the
    tail resyncs past the epoch marker, nothing re-ships, post-compaction
    appends keep flowing, the replica stays duplicate-free."""
    src = str(tmp_path / "pat.jsonl")
    dst = str(tmp_path / "replica.jsonl")
    store = PatternStore(src)
    rep = Replicator()
    rep.add(src, dst)
    _record_patterns(store, 8)
    assert rep.pump() == 8
    store.compact()                   # drains the endpoint, then rewrites
    with pytest.warns(RuntimeWarning, match="compaction marker found"):
        assert rep.pump() == 0        # resync: nothing re-ships
    assert marker_epoch(_lines(src)[-1]) == 1
    _record_patterns(store, 1, start=99)   # post-compaction: still ships
    assert rep.pump() == 1
    got = _payload_lines(dst)
    assert len(got) == len(set(got)) == 9
    # markers are per-file coordination state: they never cross the link
    assert all(marker_epoch(ln) is None for ln in _lines(dst))
    assert len(PatternStore(dst)) == 9


def test_tail_survives_evalcache_compaction(tmp_path):
    src = str(tmp_path / "cache.jsonl")
    dst = str(tmp_path / "replica.jsonl")
    cache = EvalCache(src)
    link = JournalLink(src, dst)
    for i in range(6):
        cache.get_or_compute(canonical_spec("gemm", {"t": i}, 1, "torch-cpu"),
                             lambda i=i: EvalRecord(time_s=float(i + 1)))
    assert link.pump() == 6
    cache.compact()
    with pytest.warns(RuntimeWarning, match="compaction marker found"):
        assert link.pump() == 0
    cache.get_or_compute(canonical_spec("gemm", {"t": 99}, 1, "torch-cpu"),
                         lambda: EvalRecord(time_s=0.5))
    assert link.pump() == 1
    got = _payload_lines(dst)
    assert len(got) == len(set(got)) == 7
    # the replica replays into an equivalent cache view
    assert len(EvalCache(dst)) == 7


def test_evalcache_auto_compaction_thresholds(tmp_path):
    """Churning one key past the line/ratio thresholds triggers the
    automatic rewrite; the snapshot keeps last-wins semantics and closes
    with the epoch marker."""
    path = str(tmp_path / "cache.jsonl")
    cache = EvalCache(path)
    cache.COMPACT_MIN_LINES = 16      # CI-scale thresholds
    spec = canonical_spec("gemm", {"t": 0}, 1, "torch-cpu")
    for i in range(40):
        # accept-veto forces a recompute + last-wins republish: the
        # documented way one key churns many journal lines
        cache.get_or_compute(spec,
                             lambda i=i: EvalRecord(time_s=float(i + 1)),
                             accept=lambda r: False)
    lines = _lines(path)
    assert len(lines) < 40            # a rewrite happened
    # the marker sits where the rewrite closed; later churn appends
    # after it (the tail only needs the LAST marker to resync)
    assert any(marker_epoch(ln) is not None for ln in lines)
    assert EvalCache(path).lookup(spec).time_s == 40.0


def test_replayed_snapshot_skips_event_lines(tmp_path):
    """A compacted PatternStore snapshot contains ``{"ev": "acc"}``
    aggregates; replaying those to a peer that already folded the raw
    hint events would double-count — event lines never replay."""
    def raw(i):
        return json.dumps({"family": "matmul", "platform": "tpu",
                           "delta": {"block_m": 64 + i}, "gain": 1.5 + i,
                           "source_kernel": f"k{i}",
                           "ts": float(i)}).encode()

    src = str(tmp_path / "a.jsonl")
    dst = str(tmp_path / "b.jsonl")
    link = JournalLink(src, dst)
    with open(src, "ab") as f:
        f.write(raw(0) + b"\n")
    assert link.pump() == 1
    # a compaction rewrite underneath the tail, with an unshipped
    # pattern and an aggregate event in the snapshot — via os.replace,
    # the stores' actual rewrite move (a fresh inode forces the resync)
    tmp = src + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw(0) + b"\n")
        f.write(raw(1) + b"\n")                # never shipped: must cross
        f.write(b'{"ev": "acc", "key": "k", "n": 3, "wins": 2}\n')
        f.write(json.dumps({"ev": "compact", "epoch": 1, "host": "x",
                            "pid": 1, "ts": 0.0}).encode() + b"\n")
    os.replace(tmp, src)
    with pytest.warns(RuntimeWarning, match="compaction marker found"):
        assert link.pump() == 1                # only the unseen pattern
    got = _lines(dst)
    assert raw(1) in got
    assert not any(b'"ev"' in ln for ln in got)


# ------------------------------------------------------ fleet, e2e -------
@pytest.mark.slow
def test_chaos_fleet_matches_fault_free_run(tmp_path):
    """THE acceptance criterion: a 2-host loopback fleet campaign with a
    scripted mid-campaign server kill, a dropped connection mid-line,
    and a forced compaction on a replicated PatternStore produces winner
    records identical to the fault-free run — and the ResultsDB journal
    shows the quarantine → reroute → readmission transitions.

    Batch 1 is [gemm, bicg]: the server that draws gemm dies *before*
    evaluating (kill fires pre-eval, so the fault lands while the other
    host is mid-bicg) — quarantine releases the claim, and the healthy
    host steals the retry long before the quarantined host's probe can
    respawn its server (a full interpreter start), making the reroute
    deterministic.  Batch 2 is all four cases with a torn reply on atax,
    after a forced compaction of the replicated scheduler store."""
    def _batch1():
        return [j for j in _jobs() if j.case.name in ("gemm", "bicg")]

    # fault-free reference (separate journals, same two batches)
    ref_dir = tmp_path / "ref"
    camp = Campaign(model_platform(),
                    cache=EvalCache(str(ref_dir / "cache.jsonl")),
                    db=ResultsDB(str(ref_dir / "db.jsonl")),
                    patterns=str(ref_dir / "pat.jsonl"),
                    executor=InProcessExecutor(2))
    reference = _winners(camp.run(_batch1())) + _winners(camp.run(_jobs()))

    # chaos leg: kill one host's server at its first gemm eval, tear the
    # reply connection at the first atax eval (each exactly once across
    # server respawns, via the flag latch)
    plan = FaultPlan([
        Fault("kill_server", match="gemm",
              flag=str(tmp_path / "kill.flag")),
        Fault("drop_connection", match="atax",
              flag=str(tmp_path / "drop.flag")),
    ])
    hosts = [FleetHost(name="chaosA",
                       patterns_path=str(tmp_path / "hostA-pat.jsonl")),
             FleetHost(name="chaosB",
                       patterns_path=str(tmp_path / "hostB-pat.jsonl"))]
    ex = RemoteExecutor(hosts, retries=2,
                        backoff_base_s=0.05, backoff_max_s=0.5,
                        backoff_attempts=4, quarantine_after=1,
                        probe_base_s=0.2, probe_max_s=1.0, chaos=plan)
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    store = PatternStore(str(tmp_path / "pat.jsonl"))
    camp = Campaign(model_platform(),
                    cache=EvalCache(str(tmp_path / "cache.jsonl")),
                    db=db, patterns=store, executor=ex)
    try:
        got = _winners(camp.run(_batch1()))
        # forced compaction on a live replicated endpoint, mid-campaign
        store.compact()
        # batch 2: a still-quarantined host's slot gate probes at
        # campaign start, respawns the killed server, and readmits —
        # while replication must keep flowing across the compacted
        # journal and the atax reply is torn mid-line
        got += _winners(camp.run(_jobs()))
    finally:
        ex.close()

    assert got == reference            # identical winners, faults and all

    events = ex.fleet_events()
    assert events["quarantines"] >= 1
    assert events["readmissions"] >= 1
    assert events["reroutes"] >= 1
    assert events["reconnects"] >= 1
    # the transitions are journaled, not just counted
    quar = list(db.records("host_quarantined"))
    assert quar and quar[0]["fault"] in ("crash", "timeout", "connect")
    assert list(db.records("host_readmitted"))
    rer = list(db.records("job_rerouted"))
    assert rer and all(r["origin"] != r["host"] for r in rer)
    assert list(db.records("worker_fault"))
    ends = list(db.records("campaign_end"))
    assert ends and ends[-1]["fleet"]["quarantines"] >= 1

    # replication stayed healthy through faults + compaction: each host
    # journal is duplicate-free and no marker crossed a link
    for h in hosts:
        lines = _payload_lines(h.patterns_path)
        assert lines and len(lines) == len(set(lines))
        assert all(marker_epoch(ln) is None for ln in _lines(h.patterns_path))
        # every host pattern made it home to the scheduler's store
        assert {p.source_kernel for p in PatternStore(h.patterns_path)
                .patterns} <= {p.source_kernel for p in
                               PatternStore(store.path).patterns}


# ------------------------------------------- against the JAX package -----
def test_backoff_schedule_equals_the_jax_packages():
    from repro.core import backoff_schedule as jbackoff_schedule
    for args in ((0.05, 2.0, 6), (1.0, 4.0, 5), (1.0, 4.0, 0),
                 (0.3, 9.0, 8), (0.5, 5.0, 3), (0.2, 1.0, -2)):
        assert backoff_schedule(*args) == jbackoff_schedule(*args)


def test_a_fault_plan_written_by_jax_parses_to_the_same_faults(tmp_path):
    from repro.core import Fault as JFault
    from repro.core import FaultPlan as JFaultPlan
    kw = [dict(kind="kill_server", match="gemm", at_nth=2, exit_code=45),
          dict(kind="stall", sleep_s=1.5, host="fleetB"),
          dict(kind="drop_connection", match="atax",
               flag=str(tmp_path / "drop.flag")),
          dict(kind="corrupt_journal", path=str(tmp_path / "p.jsonl"),
               payload="x {")]
    env = JFaultPlan([JFault(**d) for d in kw]).to_env({})
    plan = FaultPlan.from_env(env)
    assert plan.faults == [Fault(**d) for d in kw]
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert plan.to_json() == env[CHAOS_ENV]
