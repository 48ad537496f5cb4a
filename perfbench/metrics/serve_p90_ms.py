"""The tail of one ``predict_batch`` call, host clock to its one fetch: the
90th percentile over every call of the window (Python's
``statistics.quantiles(n=10)``)."""

import statistics

NAME, UNIT, TRACE = "serve_p90_ms", "ms", 0


def read(record):
    calls = record.get("call_ms") if record.get("kind") == "serve" else None
    if not calls or len(calls) < 2:
        return None
    return statistics.quantiles(calls, n=10)[8]
