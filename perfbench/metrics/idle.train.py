"""idle.train: the share of the traced window in which no operation ran on
the device (``torch.profiler``)."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
