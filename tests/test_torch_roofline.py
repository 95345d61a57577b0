"""The port's roofline and report (``repro_torch.launch.roofline``,
``.report``) held against the JAX package's ``repro.launch.roofline``.

``model_flops`` is the JAX package's for every config and shape; a
``Roofline``'s ``to_dict`` has the JAX one's keys; its terms use the
H100's figures (``repro_torch.hw``); and the report's tables render from
records the port's dry run wrote.
"""
import os
import subprocess
import sys

import pytest

from repro.configs import REGISTRY, SHAPES
from repro.configs import get_config as jax_config
from repro.launch import roofline as jrl

from repro_torch import hw
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import hlo_cost, report
from repro_torch.launch import roofline as rl


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_model_flops_match_jax(arch):
    for shape in SHAPES:
        assert rl.model_flops(get_config(arch), get_shape(shape.name)) \
            == jrl.model_flops(jax_config(arch), shape)


ROOF = dict(flops_per_chip=3.2e14, bytes_per_chip=4.1e11,
            collective_bytes_per_chip=9.5e9, n_chips=256,
            model_flops_total=1.1e16, bytes_per_chip_upper=2.2e12)


def test_to_dict_keys_match_jax():
    stats = dict(bytes_by_kind={"all-gather": 5}, count_by_kind={"all-gather": 1})
    port = rl.Roofline(**ROOF, collectives=rl.CollectiveStats(**stats))
    ref = jrl.Roofline(**ROOF, collectives=jrl.CollectiveStats(**stats))
    got, want = port.to_dict(), ref.to_dict()
    assert list(got) == list(want)
    assert list(got["diagnosis"]) == list(want["diagnosis"])
    for key in ("flops_per_chip", "bytes_per_chip", "n_chips",
                "collective_bytes_by_kind", "collective_count_by_kind"):
        assert got[key] == want[key]


def test_terms_use_the_h100_figures():
    r = rl.Roofline(**ROOF)
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.LINK_BW) == (989e12, 3.35e12,
                                                           50e9)
    assert r.compute_s == ROOF["flops_per_chip"] / 989e12
    assert r.memory_s == ROOF["bytes_per_chip"] / 3.35e12
    assert r.memory_s_upper == ROOF["bytes_per_chip_upper"] / 3.35e12
    assert r.collective_s == ROOF["collective_bytes_per_chip"] / 50e9
    assert r.step_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert r.dominant == "compute"
    assert r.useful_flops_ratio == ROOF["model_flops_total"] / (
        ROOF["flops_per_chip"] * 256)
    assert r.model_flops_utilization == pytest.approx(
        ROOF["model_flops_total"] / (256 * 989e12) / r.step_s)


def test_from_cost_reads_the_counter():
    cost = hlo_cost.Cost(flops=1e12, hbm_bytes=8e9, hbm_bytes_ideal=2e9,
                         coll_bytes={"all-gather": 3e8, "all-reduce": 2e8},
                         coll_count={"all-gather": 4, "all-reduce": 1})
    r = rl.from_cost(cost, n_chips=4, model_flops_total=3e12)
    assert (r.flops_per_chip, r.bytes_per_chip, r.bytes_per_chip_upper,
            r.collective_bytes_per_chip) == (1e12, 2e9, 8e9, 5e8)
    assert r.collectives.bytes_by_kind == {"all-gather": 300000000,
                                           "all-reduce": 200000000}
    assert r.collectives.count_by_kind == {"all-gather": 4, "all-reduce": 1}
    assert r.dominant == "collective" and r.collectives.total_bytes == 5e8


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's dry run's records: whisper-medium x decode_32k (OK) and
    glm4-9b x long_500k (SKIP), on the single pod."""
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    for arch, shape in (("whisper-medium", "decode_32k"),
                        ("glm4-9b", "long_500k")):
        run = subprocess.run(
            [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--single-pod", "--out",
             str(path)], env=env, capture_output=True, text=True,
            timeout=300)
        assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    return path


def test_report_renders_the_ports_records(records):
    rows = report.load(str(records))
    assert {k: r["status"] for k, r in rows.items()} == {
        ("whisper-medium", "decode_32k", "16x16"): "OK",
        ("glm4-9b", "long_500k", "16x16"): "SKIP"}
    head, _, *body = report.dryrun_table(rows).splitlines()
    ok = next(line for line in body if "whisper-medium" in line)
    skip = next(line for line in body if "glm4-9b" in line)
    assert "count s" in head and "GiB/rank" in head and "TPU" not in head
    rec = rows[("whisper-medium", "decode_32k", "16x16")]
    assert f"| {rec['count_s']} |" in ok and "✓" in ok
    assert report.fmt_bytes(rec["memory"]["peak_bytes"]) in ok
    assert "SKIP: long_500k needs sub-quadratic attention" in skip
    roof = report.roofline_table(rows).splitlines()
    assert len(roof) == 3 and roof[2].startswith("| whisper-medium |")
    assert f"**{rec['roofline']['dominant']}**" in roof[2]


def test_report_main_names_the_h100(records, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["report", str(records)])
    report.main()
    out = capsys.readouterr().out
    assert "1 OK / 1 SKIP / 0 FAIL; 1/1 fit the H100 80GB's" in out
    assert f"{hw.HBM_BYTES / 2**30:.2f} GiB a rank" in out
    assert "256 ranks, one H100 80GB each" in out
    assert "16 GiB" not in out and "chips" not in out
