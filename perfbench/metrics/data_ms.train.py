"""data_ms.train: the mean host time of the window's ``make_global_batch``
calls (drawing the rows on the host and copying them to the card; the
copy from pageable memory waits for the stream, so a call also holds the
tail of the step before it)."""


def read(rec):
    if rec["kind"] != "train" or not rec["data_s"]:
        return None
    return sum(rec["data_s"]) / len(rec["data_s"]) * 1e3
