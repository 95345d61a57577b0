"""decode_device_ms: the mean device ms of the traced slice's replays of the
decode graph (the program's ``serve.replay`` spans of graph ``decode``,
timed by CUDA events on the stream).  None without a trace, or where the
program records no such span."""
import recorder


def read(rec):
    got = recorder.session(rec, "serve")
    if got is None:
        return None
    tracing, sess = got
    ms = [tracing.device_ms(s) for s in tracing.named(sess, "serve.replay")
          if s["attrs"].get("graph") == "decode" and s["device"]]
    return sum(ms) / len(ms) if ms else None
