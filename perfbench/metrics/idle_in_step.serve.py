"""idle_in_step.serve: the share of the program's traced session (its first
device interval's start to its last one's end) in which the device was
idle while the host had a ``serve.step`` open: the idle the server's own
work leaves, apart from the caller's between steps
(``repro_torch.tracing.idle_split``).  None without a trace, or where the
program records no step or no device interval."""
import recorder


def read(rec):
    got = recorder.session(rec, "serve")
    if got is None:
        return None
    tracing, sess = got
    split = tracing.idle_split(sess)
    if split is None or split["window_ns"] <= 0 \
            or not tracing.named(sess, "serve.step"):
        return None
    return 100.0 * split["under"].get("serve.step", 0) / split["window_ns"]
