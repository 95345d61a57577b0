"""data_draw_ms.train: the mean host ms of the traced steps' ``data.draw``
spans: ``make_global_batch`` drawing the rows on the host, before the copy
to the device that waits for the stream.  None without a trace, or where
the program records no such span."""
import recorder


def read(rec):
    got = recorder.session(rec, "train")
    if got is None:
        return None
    tracing, sess = got
    t = tracing.totals(sess).get("data.draw")
    return t["host_ms"] / t["n"] if t else None
