"""Host time of ``ServingModel._upload`` (the wire encoding and the copies
of every raw input to the card) per call of the traced window, from the
benchmark's span round it."""

import statistics

NAME, UNIT, TRACE = "serve.upload_ms", "ms", 1


def read(record):
    times = (record.get("host_spans_ms") or {}).get("upload")
    return statistics.fmean(times) if record.get("kind") == "serve" and times else None
