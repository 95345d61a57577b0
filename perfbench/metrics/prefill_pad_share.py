"""prefill_pad_share: the share of the positions the traced slice's packed
prefills ran (bucket x padded rows, the program's counter
``serve.prefill_positions``) that held no prompt token (its counter
``serve.prefill_tokens``), as a percentage.  None without a trace, or
where the program counts no prefill."""
import recorder


def read(rec):
    got = recorder.session(rec, "serve")
    if got is None:
        return None
    counters = got[1]["counters"]
    positions = counters.get("serve.prefill_positions", 0)
    if positions <= 0:
        return None
    return 100.0 * (1.0 - counters.get("serve.prefill_tokens", 0) / positions)
