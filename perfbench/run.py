"""One run of one benchmark cell of the port (``repro_torch``):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell in ``BENCHMARK.json``, its
configuration under ``perfbench/configs/``, its traffic under
``perfbench/traffic/``, its limits under ``perfbench/limits/`` and the
driver the configuration names under ``perfbench/drivers/``; the driver
sets up, warms up, measures for ``--seconds`` and checks the outputs
against the plain reference.  With ``--trace 0`` the last line of standard
output reports the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the trace's breakdown; each metric is read by its
own file under ``perfbench/metrics/``.  The numbers compared with the
reference close standard error and the result line.

Exits non-zero, with no result line, without a CUDA card (or with fewer
than the cell asks for), outside a checkout of the repository, or when a
module of JAX or of the JAX package is loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# kernel and compiler caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}


def load_cell(bench: dict, name: str):
    """(cell, configuration, traffic, limits) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return cell, config, traffic, {k: v["limit"] for k, v in limits.items()}


def _reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, trace: bool):
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    a trace, the per-layer ones with it."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def execute(bench, cell, config, traffic, limits, *, seed, seconds, trace,
            device="cuda", aot=True, t0=None) -> dict:
    """Runs the cell's driver and reads its metrics.  Returns the result
    (every key but ``device``'s card fields) with ``checks`` last.  The
    tests run it on the CPU (``device``, ``aot``)."""
    import common
    smi = {}
    ctx = {"config": config, "traffic": traffic, "limits": limits,
           "seed": seed, "seconds": seconds, "trace": trace,
           "device": device, "aot": aot,
           "t0": T0 if t0 is None else t0,
           "before_window": lambda: smi.__setitem__("before",
                                                    common.smi_sample()),
           "after_window": lambda: smi.__setitem__("after",
                                                   common.smi_sample())}
    driver = importlib.import_module(f"drivers.{config['driver']}")
    out = driver.run(ctx)
    record = out["record"]
    record["config"] = config
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = _reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for when in ("before", "after"):
        if smi.get(when):
            print(f"card {when} the window: " + ", ".join(
                f"{k} {v}" for k, v in smi[when].items()), flush=True)
    checks = {c["name"]: {"value": c["value"], "limit": c["limit"]}
              for c in out["checks"]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    tr = record.get("trace")
    if trace and tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": common.top(tr["device_ops"]),
                               "idle_gaps": common.top(tr["idle"])}
    result["details"] = out["checks"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"no program under {ROOT / 'src'}: run from a checkout of the "
              "repository", file=sys.stderr)
        return 4
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic, limits = load_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import common
    result = execute(bench, cell, config, traffic, limits, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace))
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"the run loaded forbidden modules: {loaded}", file=sys.stderr)
        return 5
    dev = result["device"]
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **dev}
    print("checks: " + json.dumps(result.pop("details")), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
