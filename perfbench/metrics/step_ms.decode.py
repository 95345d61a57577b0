"""step_ms.decode: the mean host time of the window's ``step()`` calls that
admitted nothing (one decode graph replay; the call ends in a copy of the
tokens to the host)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    ts = [s["t_b"] - s["t_a"] for s in rec["steps"] if not s["admitted"]]
    return sum(ts) / len(ts) * 1e3 if ts else None
