"""Population search in the port (``repro_torch.core.population``) against
the JAX package's (``repro.core.population``).

Mirrors every in-process case of ``tests/test_population.py`` on the
analytic ``h100-model`` (constructed with ``device="cpu"``: FE runs the
plain versions), then holds the two packages against each other:

* (i) each persona's heuristic clone proposes the same variants from the
  same ``RoundState`` in both packages, for ``gemm``, ``rwkv_wkv`` and
  ``mamba_ssd`` (states drawn from a numpy seed);
* (ii) ``Population`` on one stub platform, whose timing and feedback are
  the same pure functions of the variant in both packages, gives identical
  winners, per-persona stats, raced kills and migrations;
* (iv) a ``patterns.jsonl`` written by either package's population
  campaign gives the same ``suggest_migrants`` in the other;
* (v) the ``PopulationConfig`` and ``OptConfig`` wire dicts equal the
  reference's.

The validity of a tile is the platform's: the port checks K1's shared
memory a block, the JAX package the TPU's VMEM.  Where gemm's 256 tiles
make them differ, the JAX side runs with the port's rule (``_valid``
patched in the test), so the comparison sees the move sets alone.
Everything runs on the CPU, exactly: no tolerance is involved.
"""
import json
import random
import threading
import zlib

import numpy as np
import pytest
import torch

import repro.core.proposer as jproposer_mod
from repro.core import Campaign as JCampaign
from repro.core import CaseJob as JCaseJob
from repro.core import HeuristicProposer as JHeuristicProposer
from repro.core import InProcessExecutor as JInProcessExecutor
from repro.core import MEPConstraints as JMEPConstraints
from repro.core import OptConfig as JOptConfig
from repro.core import PatternStore as JPatternStore
from repro.core import Platform as JPlatform
from repro.core import PopulationConfig as JPopulationConfig
from repro.core import get_case as jget_case
from repro.core.diagnosis import classify as jclassify
from repro.core.measure import MeasureConfig as JMeasureConfig
from repro.core.measure import measure_callable as jmeasure_callable
from repro.core.proposer import RoundState as JRoundState
from repro_torch.core import (Campaign, CaseJob, DirectProposer, EvalCache,
                              H100ModelPlatform, HeuristicProposer,
                              LLMBatcher, LLMProposer, MEPConstraints,
                              OptConfig, OptResult, PatternStore, Platform,
                              PopulationConfig, ResultsDB, get_case,
                              persona_proposers, proposer_from_spec,
                              run_case_job)
from repro_torch.core.diagnosis import classify
from repro_torch.core.measure import MeasureConfig, measure_callable
from repro_torch.core.population import MIGRANT_PERSONA, SEED_PERSONA, _vkey
from repro_torch.core.proposer import (_PERSONA_KEYS, PERSONAE, Proposer,
                                       RoundState)
from repro_torch.core.proposer import _valid as port_valid

FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
POP = PopulationConfig(size=3, generations=3, per_persona=1)
POP_CFG = OptConfig(d_rounds=8, n_candidates=2, r=5, k=1, population=POP)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """FE runs torch builds on the CPU: keep them on one core, off the
    cores that parallel test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_platform():
    return H100ModelPlatform(device="cpu")


def _job(case="gemm", seed=0, cfg=POP_CFG, proposer=None, label=""):
    return CaseJob(get_case(case),
                   proposer or HeuristicProposer(seed, platform="h100-model"),
                   cfg=cfg, constraints=FAST, seed=seed, label=label)


# ------------------------------------------------------ wire safety ----
def test_population_config_wire_roundtrip():
    pcfg = PopulationConfig(size=5, generations=4, per_persona=3,
                            personae=("tiling", "sync"), tournament=3,
                            migrate=False, max_migrants=1, patience=1)
    back = PopulationConfig.from_dict(
        json.loads(json.dumps(pcfg.to_dict())))
    assert back == pcfg
    # empty personae on the wire fall back to the full expert panel
    d = pcfg.to_dict()
    d["personae"] = []
    assert PopulationConfig.from_dict(d).personae == PERSONAE


def test_optconfig_carries_population_through_wire():
    cfg = OptConfig(d_rounds=3, population=POP)
    back = OptConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert isinstance(back.population, PopulationConfig)
    assert back.population == POP
    # the greedy default stays None either way
    plain = OptConfig.from_dict(
        json.loads(json.dumps(OptConfig().to_dict())))
    assert plain.population is None


# -------------------------------------------------- persona routing ----
def test_persona_proposers_clone_per_expert():
    base = HeuristicProposer(7, platform="h100-model")
    clones = persona_proposers(base, PERSONAE)
    assert [c.persona for c in clones] == list(PERSONAE)
    # deterministic arithmetic seed offsets — never hash()
    assert [c.seed for c in clones] == \
        [7 + 7919 * (i + 1) for i in range(len(PERSONAE))]
    assert len({c.seed for c in clones}) == len(PERSONAE)
    # the clone's spec round-trips its persona
    back = proposer_from_spec(clones[2].to_spec())
    assert back.persona == clones[2].persona == "fusion"


def test_direct_proposer_has_no_personae():
    assert persona_proposers(DirectProposer(), PERSONAE) is None


def test_llm_clones_share_batcher():
    batcher = LLMBatcher(lambda p: "[]", max_batch=4)
    base = LLMProposer(batcher=batcher)
    clones = persona_proposers(base, PERSONAE)
    assert all(c.batcher is batcher for c in clones)
    assert [c.persona for c in clones] == list(PERSONAE)


def test_expert_clone_proposes_only_its_move_set():
    """The fusion expert on gemm may only touch fusion levers
    (``fuse_epilogue`` is the single one in gemm's space)."""
    case = get_case("gemm")
    clone = HeuristicProposer(0, platform="h100-model") \
        .with_persona("fusion")
    state = RoundState(round=0,
                       baseline_variant=dict(case.baseline_variant),
                       baseline_time_s=1.0,
                       feedback=model_platform().profile_feedback(
                           case, case.baseline_variant, 1))
    allowed = set(_PERSONA_KEYS["fusion"])
    for v in clone.propose(case, state, 6):
        diff = {k for k in v if v[k] != case.baseline_variant.get(k)}
        assert diff and diff <= allowed, \
            f"fusion expert touched {diff - allowed}"


# ---------------------------------------- the evolutionary loop ---------
@pytest.fixture(scope="module")
def pop_result():
    return run_case_job(_job("gemm"), model_platform())


def test_population_search_improves_and_logs_personae(pop_result):
    res = pop_result
    assert res.speedup > 1.0
    assert res.stop_reason
    assert res.rounds, "no generation records"
    for rl in res.rounds:
        assert rl.personae, f"generation {rl.round} lost its persona stats"
        for c in rl.candidates:
            assert c.persona in set(PERSONAE) | {SEED_PERSONA,
                                                 MIGRANT_PERSONA}
    assert set(res.persona_stats) >= set(
        p for rl in res.rounds for p in rl.personae)
    total_eval = sum(st["evaluated"]
                     for st in res.persona_stats.values())
    assert total_eval == sum(len(rl.candidates) for rl in res.rounds)
    assert any("population: champion bred by" in ln
               for ln in res.mep_log)


def test_no_variant_is_ever_paid_twice(pop_result):
    res = pop_result
    keys = [_vkey(c.variant) for rl in res.rounds for c in rl.candidates]
    assert len(keys) == len(set(keys)), "a duplicate variant was paid for"


class _CollidingProposer(Proposer):
    """Every persona proposes the SAME variant: the dedup guard must
    collapse the wave to one paid evaluation and stop the search once
    nothing novel remains."""
    name = "colliding"

    def __init__(self, persona=""):
        self.persona = persona

    def with_persona(self, persona, idx=0):
        return _CollidingProposer(persona)

    def propose(self, case, state, n):
        return [dict(state.baseline_variant, block_m=64)]


def test_cross_persona_dedup_guard():
    res = run_case_job(_job(proposer=_CollidingProposer()),
                       model_platform())
    g0 = res.rounds[0]
    assert sum(st["proposed"] for st in g0.personae.values()) \
        == len(PERSONAE)
    assert sum(st["evaluated"] for st in g0.personae.values()) == 1
    assert len(g0.candidates) == 1
    assert res.stop_reason == "wave exhausted (no novel candidates)"
    assert all(len(rl.candidates) == 0 for rl in res.rounds[1:])


def test_greedy_fallback_without_personae():
    """DirectProposer supports no personae: a population config degrades
    to the greedy loop and leaves no population evidence behind."""
    cfg = OptConfig(d_rounds=1, n_candidates=1, r=5, k=1, population=POP)
    res = run_case_job(_job(cfg=cfg, proposer=DirectProposer()),
                       model_platform())
    assert isinstance(res, OptResult)
    assert not res.persona_stats and res.raced_kills == 0
    assert all(not rl.personae for rl in res.rounds)


def test_a_set_stop_event_ends_either_search_at_its_first_boundary():
    """``Campaign.run(stop=...)``: a set event stops the population search
    before its first generation and the greedy loop before its first
    round, each with a valid result at the baseline."""
    stop = threading.Event()
    stop.set()
    for cfg in (POP_CFG, OptConfig(d_rounds=3, n_candidates=2, r=5, k=1)):
        res = Campaign(model_platform(), max_workers=1).run(
            [_job(cfg=cfg)], stop=stop)[0]
        assert res.stop_reason == "stop requested" and not res.rounds
        assert res.best_variant == res.baseline_variant


# ------------------------------------------------ tournament racing ----
def scripted_mean(variant) -> float:
    """bf16 storage (a move every expert reaches early) is 4-5x faster
    than everything else; the losers' means come from a stable digest,
    not the salted builtin hash(), so they sit at 2.0-2.6 in every
    process."""
    if variant.get("compute_dtype") == "bf16":
        return 0.5
    digest = zlib.crc32(repr(sorted(variant.items())).encode())
    return 2.0 + (digest % 7) / 10.0


class _ScriptedPlatform(Platform):
    """Measured-style platform with a deterministic pseudo-noise clock:
    tournament racing must retire the losers at r_min."""
    name = "scripted"
    concurrency_safe = False

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        mean = scripted_mean(variant)
        rng = random.Random(repr(sorted(variant.items())))
        return measure_callable(
            lambda: mean * rng.uniform(0.9, 1.1), r=r, k=k,
            cfg=budget, incumbent_s=incumbent_s)


def test_tournament_racing_retires_losers():
    cfg = OptConfig(d_rounds=8, n_candidates=2, r=30, k=3,
                    measure=MeasureConfig(ci_rel=0.001),
                    population=PopulationConfig(size=3, generations=4,
                                                per_persona=2))
    res = run_case_job(_job(cfg=cfg), _ScriptedPlatform())
    assert res.raced_kills > 0, "racing never triggered"
    assert res.raced_kills == sum(rl.raced_kills for rl in res.rounds)
    assert res.raced_kills == sum(st["raced"]
                                  for st in res.persona_stats.values())
    # a raced-out challenger is a loss by construction: never the winner
    assert res.best_variant.get("compute_dtype") == "bf16"
    raced = [c.variant for rl in res.rounds for c in rl.candidates
             if c.raced_out]
    assert res.best_variant not in raced
    # racing + CI stop paid fewer reps than fixed-R would have
    assert 0 < res.timing_reps < res.timing_reps_fixed


# ------------------------------------------------- island migration ----
def test_migration_between_cases(tmp_path):
    """gemm then 2mm in one in-process campaign: gemm's exported deltas
    surface in 2mm's generations as seed/migrant entries, and the journal
    carries the full population evidence."""
    store = PatternStore(str(tmp_path / "pat.jsonl"))
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    camp = Campaign(model_platform(), patterns=store, db=db,
                    cache=EvalCache(str(tmp_path / "ec.jsonl")),
                    max_workers=1, population=POP)
    cfg = OptConfig(d_rounds=8, n_candidates=2, r=5, k=1)
    gemm, mm2 = camp.run([_job("gemm", cfg=cfg), _job("2mm", cfg=cfg)])
    assert gemm.migrations_out > 0, "gemm never exported an improvement"
    cross = [m for rl in mm2.rounds for m in rl.migrations
             if m["source"] == "gemm"]
    assert cross, "gemm's win never reached 2mm's generations"
    assert all({"source", "delta", "gain", "bottleneck", "persona",
                "joined"} <= set(m) for m in cross)
    assert mm2.hints_suggested > 0
    rounds = [r for r in db.records("round") if r["job"] == "2mm"]
    assert rounds
    assert all("personae" in r and "raced_kills" in r
               and "migrations" in r for r in rounds)
    assert any(m["source"] == "gemm"
               for r in rounds for m in r["migrations"])
    personae_seen = {p for r in rounds for p in r["personae"]}
    assert personae_seen & set(PERSONAE)
    assert any(c.get("persona") for r in rounds
               for c in r.get("candidates", []))


def test_migrants_are_cross_case_only(tmp_path):
    """``suggest_migrants`` never feeds a case its own history back."""
    store = PatternStore(str(tmp_path / "pat.jsonl"))
    gemm, mm2 = get_case("gemm"), get_case("2mm")
    store.record(gemm, "h100-model", dict(gemm.baseline_variant),
                 dict(gemm.baseline_variant, block_m=128), gain=5.0)
    store.record(mm2, "h100-model", dict(mm2.baseline_variant),
                 dict(mm2.baseline_variant, compute_dtype="bf16"), gain=3.0)
    migrants = store.suggest_migrants(gemm, "h100-model", max_hints=4)
    assert migrants and all(p.source_kernel != "gemm" for p in migrants)
    assert any(p.source_kernel == "2mm" for p in migrants)
    # the case's own pattern IS still a seed (suggest_patterns)
    assert any(p.source_kernel == "gemm" for p in
               store.suggest_patterns(gemm, "h100-model"))


def _population_campaign(base):
    store = PatternStore(str(base / "pat.jsonl"))
    camp = Campaign(model_platform(), patterns=store,
                    cache=EvalCache(str(base / "ec.jsonl")), max_workers=1,
                    population=POP)
    cfg = OptConfig(d_rounds=8, n_candidates=2, r=5, k=1)
    results = camp.run([_job("gemm", cfg=cfg), _job("atax", cfg=cfg)])
    return [(r.case_name, r.best_variant, round(r.best_time_s, 15),
             len(r.rounds), r.stop_reason,
             [c.persona for rl in r.rounds for c in rl.candidates])
            for r in results]


def test_population_winner_records_conform(tmp_path):
    """The same campaign twice, from fresh stores and caches, gives
    identical winner records (variant, time, generation count, stop
    reason, the persona sequence): string-seeded RNG and no wall clock in
    selection.  The port has one executor, so this is its conformance
    gate."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert _population_campaign(tmp_path / "a") == \
        _population_campaign(tmp_path / "b")


# --------------------------------- LLM wave coalescing ----------------
def _wave_transport(log, reply_for):
    """Scripted endpoint: parses the batcher's tagged sections, maps each
    id to its persona by preamble text, and answers per persona."""
    markers = {"TILING": "tiling", "MEMORY-LAYOUT": "memory",
               "FUSION/RESTRUCTURE": "fusion",
               "SYNCHRONIZATION/LATENCY": "sync"}

    def _persona_of(text):
        return next((p for m, p in markers.items() if m in text), "")

    def transport(prompt):
        log.append(prompt)
        sections = {}
        cur = None
        for ln in prompt.splitlines():
            if ln.startswith("### "):
                cur = ln.split()[-1]
                sections[cur] = []
            elif cur is not None:
                sections[cur].append(ln)
        if not sections:       # un-batched single prompt
            return json.dumps(reply_for(_persona_of(prompt)))
        return json.dumps(
            {sid: reply_for(_persona_of("\n".join(lines)))
             for sid, lines in sections.items()})
    return transport


_PERSONA_REPLY = {
    "tiling": [{"block_m": 64}],
    "memory": [{"compute_dtype": "bf16"}],
    "fusion": [{"fuse_epilogue": True}],
    "sync": [{"block_n": 64}],
}


def _llm_job(batcher, generations):
    cfg = OptConfig(d_rounds=8, n_candidates=2, r=5, k=1,
                    population=PopulationConfig(size=4,
                                                generations=generations,
                                                per_persona=1,
                                                migrate=False))
    return _job(cfg=cfg, proposer=LLMProposer(batcher=batcher))


def test_llm_wave_coalesces_into_one_call():
    prompts = []
    transport = _wave_transport(prompts,
                                lambda p: _PERSONA_REPLY.get(p, []))
    batcher = LLMBatcher(transport, max_batch=len(PERSONAE))
    res = run_case_job(_llm_job(batcher, 2), model_platform())
    assert isinstance(res, OptResult)
    gens = len(res.rounds)
    assert batcher.calls == gens
    assert batcher.coalesced == gens * len(PERSONAE)
    assert all(ln.count("\n### k") == len(PERSONAE)
               for ln in prompts if ln.startswith("You are optimizing"))
    first = prompts[0]
    for marker in ("TILING", "MEMORY-LAYOUT", "FUSION/RESTRUCTURE",
                   "SYNCHRONIZATION/LATENCY"):
        assert marker in first, f"{marker} persona missing from the wave"


def test_llm_wave_replies_route_to_their_persona():
    transport = _wave_transport([],
                                lambda p: _PERSONA_REPLY.get(p, []))
    batcher = LLMBatcher(transport, max_batch=len(PERSONAE))
    res = run_case_job(_llm_job(batcher, 1), model_platform())
    base = res.baseline_variant
    bred = {c.persona: c.variant for rl in res.rounds
            for c in rl.candidates}
    for persona, delta in _PERSONA_REPLY.items():
        assert persona in bred, f"{persona} never bred a candidate"
        assert bred[persona] == dict(base, **delta[0]), \
            f"{persona}'s reply was routed to the wrong expert"


def test_llm_wave_isolates_one_personas_garbage():
    """The fusion section gets a non-JSON reply: that persona errors, the
    other three still breed."""
    def reply_for(persona):
        if persona == "fusion":
            return "I'd rather not answer in JSON today."
        return _PERSONA_REPLY.get(persona, [])

    batcher = LLMBatcher(_wave_transport([], reply_for),
                         max_batch=len(PERSONAE))
    res = run_case_job(_llm_job(batcher, 1), model_platform())
    rl = res.rounds[0]
    assert rl.personae["fusion"].get("errors", 0) >= 1
    assert rl.personae["fusion"]["evaluated"] == 0
    for p in (p for p in PERSONAE if p != "fusion"):
        assert rl.personae[p]["evaluated"] >= 1, \
            f"{p} was poisoned by fusion's garbage reply"
    assert res.speedup > 1.0


# ======================================================================
# the port against the JAX package
# ======================================================================
def _drawn_state(pkg, case, rng, rnd):
    """A RoundState for ``pkg`` ("jax" or "torch") drawn from ``rng``: a
    baseline and history of in-space variants, feedback counters, two PPI
    hint deltas, and the diagnosis of drawn roofline terms (each package's
    own ``classify``)."""
    space = case.variant_space

    def variant():
        return {k: ch[int(rng.integers(len(ch)))] for k, ch in space.items()}

    base = dict(case.baseline_variant) if rnd == 0 else variant()
    history = [{"variant": variant(), "time_s": float(rng.random()),
                "status": "ok", "raced_out": False} for _ in range(3)]
    hints = [{k: v} for k, v in list(variant().items())[:2]]
    feedback = {"flops": float(rng.random() * 1e9),
                "traffic_bytes": float(rng.random() * 1e8),
                "arithmetic_intensity": float(rng.random() * 400)}
    terms = rng.random(3)
    util, vmem = float(rng.random()), float(rng.random())
    cls, RS = (jclassify, JRoundState) if pkg == "jax" \
        else (classify, RoundState)
    diag = cls(float(terms[0]), float(terms[1]), float(terms[2]) * 0.5,
               mxu_utilization=util, vmem_fraction=vmem)
    return RS(round=rnd, baseline_variant=base, baseline_time_s=1.0,
              feedback=feedback, history=history, errors=[],
              hints=hints, diagnosis=diag)


@pytest.mark.parametrize("name", ["gemm", "rwkv_wkv", "mamba_ssd"])
@pytest.mark.parametrize("persona", PERSONAE)
def test_persona_clones_propose_what_the_jax_clones_propose(
        name, persona, monkeypatch):
    """(i) For every persona, the port's heuristic clone and the JAX
    package's propose the same variants, in the same order, from the same
    drawn round states (round 0 and later rounds, each bottleneck the
    draws give).  gemm's JAX side checks tiles by the port's rule."""
    if name == "gemm":
        monkeypatch.setattr(jproposer_mod, "_valid", port_valid)
    idx = PERSONAE.index(persona)
    jcase, case = jget_case(name), get_case(name)
    bottlenecks, proposed = set(), 0
    for seed in range(6):
        jclone = JHeuristicProposer(seed, platform="h100-model") \
            .with_persona(persona, idx)
        clone = HeuristicProposer(seed, platform="h100-model") \
            .with_persona(persona, idx)
        for rnd in (0, 1, 2):
            jstate = _drawn_state("jax", jcase,
                                  np.random.default_rng([seed, rnd]), rnd)
            state = _drawn_state("torch", case,
                                 np.random.default_rng([seed, rnd]), rnd)
            assert jstate.diagnosis.bottleneck == state.diagnosis.bottleneck
            bottlenecks.add(state.diagnosis.bottleneck)
            got = clone.propose(case, state, 4)
            proposed += len(got)
            assert got == jclone.propose(jcase, jstate, 4)
    assert len(bottlenecks) >= 2 and proposed >= 6


def test_the_scan_cases_need_no_validity_patch():
    """For the tile-free scan cases both packages' validity rules accept
    every variant, so the clones agree without the patch (a gemm tile of
    256³ in f32 is the rule's one difference: past K1's shared memory)."""
    for name in ("rwkv_wkv", "mamba_ssd"):
        case = get_case(name)
        keys = list(case.variant_space)
        for vals in np.ndindex(*[len(case.variant_space[k]) for k in keys]):
            v = {k: case.variant_space[k][i] for k, i in zip(keys, vals)}
            assert port_valid(case, v) and jproposer_mod._valid(
                jget_case(name), v)
    big = {"block_m": 256, "block_n": 256, "block_k": 256,
           "compute_dtype": "f32", "fuse_epilogue": False}
    assert jproposer_mod._valid(jget_case("gemm"), big)
    assert not port_valid(get_case("gemm"), big)


# -- (ii) one stub platform in both packages --------------------------
def _stub_feedback(case, variant, scale):
    """Memory-bound counters, the same pure function in both packages:
    the diagnosis (either package's ``classify``) routes the memory
    expert first."""
    return {"flops": 1.0, "traffic_bytes": 1e12 * scripted_mean(variant),
            "arithmetic_intensity": 1e-12}


class _StubPlatform(Platform):
    name = "stub"
    concurrency_safe = False

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        mean = scripted_mean(variant)
        rng = random.Random(repr(sorted(variant.items())))
        return measure_callable(
            lambda: mean * rng.uniform(0.9, 1.1), r=r, k=k,
            cfg=budget, incumbent_s=incumbent_s)

    def profile_feedback(self, case, variant, scale):
        return _stub_feedback(case, variant, scale)


class _JStubPlatform(JPlatform):
    name = "stub"
    concurrency_safe = False

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        mean = scripted_mean(variant)
        rng = random.Random(repr(sorted(variant.items())))
        return jmeasure_callable(
            lambda: mean * rng.uniform(0.9, 1.1), r=r, k=k,
            cfg=budget, incumbent_s=incumbent_s)

    def profile_feedback(self, case, variant, scale):
        return _stub_feedback(case, variant, scale)


STUB_POP = dict(size=3, generations=4, per_persona=2)
STUB_CFG = dict(d_rounds=8, n_candidates=2, r=30, k=3)


def _records(results):
    """What both packages must agree on, per case."""
    return [{"case": r.case_name, "best": r.best_variant,
             "best_time_s": r.best_time_s, "stop": r.stop_reason,
             "persona_stats": r.persona_stats,
             "raced_kills": r.raced_kills,
             "migrations": (r.migrations_in, r.migrations_joined,
                            r.migrations_out),
             "timing_reps": (r.timing_reps, r.timing_reps_fixed),
             "rounds": [{"bottleneck": rl.diagnosis["bottleneck"],
                         "personae": rl.personae,
                         "raced_kills": rl.raced_kills,
                         "migrations": rl.migrations,
                         "candidates": [(c.persona, c.variant, c.status,
                                         c.time_s, c.reps, c.raced_out)
                                        for c in rl.candidates]}
                        for rl in r.rounds]}
            for r in results]


def _jax_stub_campaign(store):
    camp = JCampaign(_JStubPlatform(), patterns=store,
                     executor=JInProcessExecutor(1),
                     population=JPopulationConfig(**STUB_POP))
    cfg = JOptConfig(**STUB_CFG, measure=JMeasureConfig(ci_rel=0.001))
    fast = JMEPConstraints(t_max_s=2.0, r=5, k=1)
    return camp.run([JCaseJob(jget_case(n), JHeuristicProposer(
        0, store, "stub"), cfg=cfg, constraints=fast)
        for n in ("gemm", "2mm")])


def _port_stub_campaign(store):
    camp = Campaign(_StubPlatform(), patterns=store, max_workers=1,
                    population=PopulationConfig(**STUB_POP))
    cfg = OptConfig(**STUB_CFG, measure=MeasureConfig(ci_rel=0.001))
    return camp.run([CaseJob(get_case(n), HeuristicProposer(
        0, store, "stub"), cfg=cfg, constraints=FAST)
        for n in ("gemm", "2mm")])


@pytest.fixture(scope="module")
def stub_runs(tmp_path_factory):
    """One population campaign (gemm then 2mm, shared file-backed pattern
    store) on the stub platform in each package."""
    base = tmp_path_factory.mktemp("stub")
    mp = pytest.MonkeyPatch()
    mp.setattr(jproposer_mod, "_valid", port_valid)
    try:
        jres = _jax_stub_campaign(JPatternStore(str(base / "jax.jsonl")))
    finally:
        mp.undo()
    res = _port_stub_campaign(PatternStore(str(base / "port.jsonl")))
    return {"jax": jres, "port": res, "base": base}


def test_population_on_a_stub_platform_equals_jax(stub_runs):
    """(ii) Identical winners, times, per-persona stats, raced kills,
    migrations and every generation's candidates in both packages."""
    jrec, rec = _records(stub_runs["jax"]), _records(stub_runs["port"])
    assert rec == jrec
    gemm, mm2 = stub_runs["port"]
    assert gemm.raced_kills + mm2.raced_kills > 0, "racing never triggered"
    assert gemm.migrations_out > 0
    assert any(m["source"] == "gemm" for rl in mm2.rounds
               for m in rl.migrations), "gemm's win never reached 2mm"
    assert mm2.best_variant.get("compute_dtype") == "bf16"


def _migrant_view(store_cls, case_fn, path, platform):
    store = store_cls(str(path))
    out = {}
    for name in ("gemm", "2mm", "3mm", "atax"):
        for bottleneck in ("", "memory", "compute"):
            out[(name, bottleneck)] = [
                (p.source_kernel, p.delta, p.gain, p.bottleneck, p.pid,
                 p.ns)
                for p in store.suggest_migrants(case_fn(name), platform,
                                                max_hints=3,
                                                bottleneck=bottleneck)]
    return out


def test_jax_population_journal_gives_the_same_migrants(stub_runs):
    """(iv) The JAX campaign's ``patterns.jsonl`` (wins and hint outcomes
    recorded by its population search) read by the port's store gives the
    JAX store's ``suggest_migrants``, and the port's journal read by the
    JAX store gives the port's."""
    base = stub_runs["base"]
    for path in (base / "jax.jsonl", base / "port.jsonl"):
        jview = _migrant_view(JPatternStore, jget_case, path, "stub")
        view = _migrant_view(PatternStore, get_case, path, "stub")
        assert view == jview
        assert any(view.values()), "no migrant was suggested"
    # the two journals record the same wins
    assert _migrant_view(PatternStore, get_case, base / "jax.jsonl",
                         "stub") == \
        _migrant_view(PatternStore, get_case, base / "port.jsonl", "stub")


# -- (v) wire dicts ----------------------------------------------------
def test_population_config_wire_dict_equals_jax():
    for kw in ({}, dict(size=5, generations=4, per_persona=3,
                        personae=("tiling", "sync"), tournament=3,
                        migrate=False, max_migrants=1, patience=1)):
        d, jd = PopulationConfig(**kw).to_dict(), \
            JPopulationConfig(**kw).to_dict()
        assert d == jd
        assert PopulationConfig.from_dict(jd) == PopulationConfig(**kw)
        assert JPopulationConfig.from_dict(d) == JPopulationConfig(**kw)
    assert PopulationConfig() == PopulationConfig(
        size=4, generations=6, per_persona=2, personae=PERSONAE,
        tournament=2, migrate=True, max_migrants=2, patience=2)


def test_optconfig_wire_dict_equals_jax_but_the_kernel_check():
    """The wire dicts are the reference's, population included, with two
    stated differences: ``check_kernel`` (FE through the ``cuda`` build)
    stands where the JAX package has ``check_pallas``, and ``ppi`` waits
    for the campaign fabric."""
    kw = dict(d_rounds=3, n_candidates=2, r=7, k=1, improve_eps=0.02,
              fe_input_sets=1, fe_scale=64)
    d = OptConfig(**kw, measure=MeasureConfig(ci_rel=0.01),
                  population=POP).to_dict()
    jd = JOptConfig(**kw, measure=JMeasureConfig(ci_rel=0.01),
                    population=JPopulationConfig(
                        size=3, generations=3, per_persona=1)).to_dict()
    assert d.pop("check_kernel") is False
    assert jd.pop("check_pallas") is False and jd.pop("ppi") is True
    assert d == jd
    back = OptConfig.from_dict(dict(jd, check_kernel=False))
    assert back.population == POP and back.measure == MeasureConfig(
        ci_rel=0.01)
