"""prefill_wait_ms: the mean host ms of the traced slice's ``serve.queue``
spans: from a request's submission to the start of its own bucket's
prefill (the queue and the earlier buckets of its wave).  None without a
trace, or where the program records no such span."""
import recorder


def read(rec):
    got = recorder.session(rec, "serve")
    if got is None:
        return None
    tracing, sess = got
    t = tracing.totals(sess).get("serve.queue")
    return t["host_ms"] / t["n"] if t else None
