"""itl_p95_ms.long-prompt: ``itl_p95_ms`` read in the long-prompt cell,
where it is a per-layer metric.  Its 95th percentile falls among the gaps
that an admission wave of 1024-1920 token prompts puts into every stream,
so it follows how those waves form and swings from host to host more than
the cell's rate and TTFT tail do.  Host clock."""
import common


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["t_start"], rec["t_end"]
    gaps = [t1 - t0 for r in rec["requests"]
            for t0, t1 in zip(r["times"], r["times"][1:])
            if a < t0 and t1 <= b]
    return common.percentile(gaps, 95) * 1e3 if gaps else None
