"""itl_p95_ms: the 95th percentile of every gap between two consecutive
output tokens of a request, both inside the window.  Two tokens that one
step delivers together (a prefill's token and the first decoded one) are
a gap of 0.  Host clock."""
import common


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["t_start"], rec["t_end"]
    gaps = [t1 - t0 for r in rec["requests"]
            for t0, t1 in zip(r["times"], r["times"][1:])
            if a < t0 and t1 <= b]
    return common.percentile(gaps, 95) * 1e3 if gaps else None
