"""decode_host_ms: the host's own ms in a decode step: the mean, over the
traced slice's ``serve.step`` spans that decoded (a ``serve.readback``
below them) and prefilled nothing (no ``serve.prefill``), of the step's
host ms less the host ms of its ``serve.readback`` spans, in which the host
waits for the device, and of its ``serve.replay`` spans, the graph's
launch, which a profiler's tracing slows.  What is left is the step's own
Python, the input copies and the commit.  None without a trace, or where
the program records no such step."""
import recorder

LEFT_OUT = ("serve.readback", "serve.replay")


def read(rec):
    got = recorder.session(rec, "serve")
    if got is None:
        return None
    tracing, sess = got
    ms = []
    for step in tracing.named(sess, "serve.step"):
        below = tracing.within(sess, step)
        if any(s["name"] == "serve.prefill" for s in below) \
                or not any(s["name"] == "serve.readback" for s in below):
            continue
        ms.append(tracing.host_ms(step) - sum(
            tracing.host_ms(s) for s in below if s["name"] in LEFT_OUT))
    return sum(ms) / len(ms) if ms else None
