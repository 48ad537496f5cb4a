"""Host time of ``ServingModel._prepare`` (``Processor.make_raw`` per
observation: the tokenizer, the context frames; the pool stacked) per call
of the traced window, from the benchmark's span round it."""

import statistics

NAME, UNIT, TRACE = "serve.prepare_ms", "ms", 1


def read(record):
    times = (record.get("host_spans_ms") or {}).get("prepare")
    return statistics.fmean(times) if record.get("kind") == "serve" and times else None
