"""Render the dry-run and roofline tables from the dry run's JSONL records.

Port of ``repro.launch.report``, for the records ``launch.dryrun --out``
writes: counted in seconds (``count_s``), a rank's peak in GiB against the
H100's memory (``hw.HBM_BYTES``).

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

from repro_torch import hw

CARD = "H100 80GB"


def load(path: str) -> Dict[Tuple[str, str, str], Dict]:
    rows: Dict[Tuple[str, str, str], Dict] = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}"


def dryrun_table(rows) -> str:
    out = ["| arch | shape | mesh | rules | accum | count s | GiB/rank | fits | collective schedule (per-rank GiB: ag/ar/rs/a2a/cp) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(rows.items()):
        if r["status"] == "SKIP":
            out.append(f"| {a} | {s} | {m} | — | — | — | — | — | SKIP: {r['reason'][:60]} |"
                       .replace("| — | — | — | — | — |", "| — | — | — | — |"))
            continue
        if r["status"] != "OK":
            out.append(f"| {a} | {s} | {m} | {r.get('rules','?')} | — | — | — | FAIL | {r.get('error','')[:60]} |")
            continue
        mem = r["memory"]
        cb = r["roofline"].get("collective_bytes_by_kind", {})
        g = lambda k: cb.get(k, 0) / 2**30
        sched = (f"{g('all-gather'):.1f}/{g('all-reduce'):.1f}/"
                 f"{g('reduce-scatter'):.1f}/{g('all-to-all'):.1f}/"
                 f"{g('collective-permute'):.2f}")
        out.append(
            f"| {a} | {s} | {m} | {r.get('rules','?')} | {r.get('accum') or 1} "
            f"| {r.get('count_s','?')} "
            f"| {fmt_bytes(mem['peak_bytes'])} "
            f"| {'✓' if mem['fits_hbm'] else '✗'} | {sched} |")
    return "\n".join(out)


def roofline_table(rows, mesh="16x16") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| step s (bound) | MODEL_FLOPS | useful ratio | MFU bound | what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(rows.items()):
        if m != mesh or r["status"] != "OK":
            continue
        rf = r["roofline"]
        hint = _hint(a, s, rf)
        out.append(
            f"| {a} | {s} | {rf['compute_s']:.3f} | {rf['memory_s']:.3f} "
            f"| {rf['collective_s']:.3f} | **{rf['dominant']}** "
            f"| {rf['step_s']:.3f} | {rf['model_flops_total']:.2e} "
            f"| {rf['useful_flops_ratio']:.3f} | {rf['mfu_bound']:.3f} | {hint} |")
    return "\n".join(out)


def _hint(arch: str, shape: str, rf: Dict) -> str:
    dom = rf["dominant"]
    if dom == "collective":
        if "train" in shape or "prefill" in shape:
            return ("shrink activation AR: combine-before-reduce (MoE) / "
                    "context-parallel attention / fewer TP hops")
        return "shard KV + weights so decode psum stays activation-sized"
    if dom == "memory":
        return ("raise reuse: bigger matmul tiles, smaller scan-chunk "
                "intermediates, bf16 residency")
    return "already compute-bound: raise useful-flops ratio (remat policy)"


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    rows = load(path)
    n_ok = sum(r["status"] == "OK" for r in rows.values())
    n_skip = sum(r["status"] == "SKIP" for r in rows.values())
    n_fail = sum(r["status"] == "FAIL" for r in rows.values())
    fits = sum(r["status"] == "OK" and r["memory"]["fits_hbm"]
               for r in rows.values())
    print(f"## §Dry-run  ({n_ok} OK / {n_skip} SKIP / {n_fail} FAIL; "
          f"{fits}/{n_ok} fit the {CARD}'s {hw.HBM_BYTES / 2**30:.2f} GiB "
          f"a rank)\n")
    print(dryrun_table(rows))
    print(f"\n## §Roofline (single-pod 16×16 = 256 ranks, one {CARD} each)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
