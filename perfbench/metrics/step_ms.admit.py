"""step_ms.admit: the mean host time of the window's ``step()`` calls that
admitted a wave (packed prefill graphs, the splice into slots, then the
decode)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    ts = [s["t_b"] - s["t_a"] for s in rec["steps"] if s["admitted"]]
    return sum(ts) / len(ts) * 1e3 if ts else None
