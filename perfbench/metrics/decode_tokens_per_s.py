"""decode_tokens_per_s: every output token that reached its client in the
window, over the window's length.  Host clock."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["t_start"], rec["t_end"]
    n = sum(1 for r in rec["requests"] for t in r["times"] if a < t <= b)
    return n / rec["window_s"]
