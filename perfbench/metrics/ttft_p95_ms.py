"""ttft_p95_ms: the 95th percentile, over every request whose first token
reached its client in the window, of the time from sending it to that
token.  Host clock."""
import common


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["t_start"], rec["t_end"]
    waits = [r["times"][0] - r["sent"] for r in rec["requests"]
             if r["times"] and a < r["times"][0] <= b]
    return common.percentile(waits, 95) * 1e3 if waits else None
