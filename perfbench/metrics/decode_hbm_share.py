"""decode_hbm_share: the bytes the window's decode-only steps need (every
weight once, each row's live K/V once, its new K/V written;
``reference.counts.decode_step_bytes``) over their host time, as a share
of the H100's 3.35 TB/s."""
from reference import counts


def read(rec):
    if rec["kind"] != "serve":
        return None
    steps = [s for s in rec["steps"] if not s["admitted"] and s["decode_keys"]]
    if not steps:
        return None
    nbytes = sum(counts.decode_step_bytes(rec["model"], s["decode_keys"])
                 for s in steps)
    secs = sum(s["t_b"] - s["t_a"] for s in steps)
    return 100.0 * nbytes / secs / counts.HBM_BYTES_PER_S
