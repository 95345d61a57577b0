"""The program's own spans and counters (``repro_torch.tracing``) as the
metric readers take them: the session the traced slice recorded."""


def session(rec, kind):
    """(the recorder's module, its session) after a traced run of a
    ``kind`` cell, or None: without a trace, or where the program has no
    recorder."""
    if rec["kind"] != kind or rec.get("trace") is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing, tracing.session()
