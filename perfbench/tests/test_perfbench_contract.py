"""``BENCHMARK.json`` keeps the shape the benchmark's checker reads, and
every name it uses finds its file."""
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expan|experts_per_tok|top_k|d_model|"
                    r"d_ff")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys_and_allowed_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and \
            c["file"].startswith("perfbench/")
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + \
        BENCH["per_layer"]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in every]
    assert len(names) == len(set(names))


def test_setup_s_is_there_with_its_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


def test_cells_find_their_files_and_pairs_are_unique():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    for w in BENCH["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert (HERE / "drivers" / f"{cfg['driver']}.py").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert all("limit" in v for v in limits.values())
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_per_layer_metrics_name_their_cells_and_layer():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("path", sorted((HERE / "limits").glob("*.json")),
                         ids=lambda p: p.stem)
def test_limits_sit_between_their_readings(path):
    for name, v in json.loads(path.read_text()).items():
        if v.get("lower") is not None and v.get("upper") is not None:
            assert v["lower"] < v["limit"] < v["upper"], name
            assert v["upper"] >= 3 * v["lower"], name

