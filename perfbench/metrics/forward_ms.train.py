"""forward_ms.train: the device ms of the traced steps' ``train.forward``
spans (CUDA events on the stream), per ``train.step``.  None without a
trace, or where the program records no step or no such span on the
device."""
import recorder


def read(rec):
    got = recorder.session(rec, "train")
    if got is None:
        return None
    tracing, sess = got
    t = tracing.totals(sess)
    step, phase = t.get("train.step"), t.get("train.forward")
    if not step or not phase or not phase["device_n"]:
        return None
    return phase["device_ms"] / step["n"]
