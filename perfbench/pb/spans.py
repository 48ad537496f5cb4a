"""Host spans of the benchmark's own, put round methods of one object.

``wrap(obj, "method", spans)`` replaces ``obj.method`` on the instance with
a wrapper that times each call on the host clock (milliseconds appended to
``spans["method"]``) inside ``record_function("pb.method")``, so that the
trace can name what the host did in an idle gap. The program is not
changed: the wrapper is set on the instance the benchmark made.
"""

from __future__ import annotations

import functools
import time

from torch.profiler import record_function


def wrap(obj, method: str, spans: dict) -> None:
    inner = getattr(obj, method)
    times = spans.setdefault(method.lstrip("_"), [])

    @functools.wraps(inner)
    def timed(*args, **kwargs):
        with record_function("pb." + method.lstrip("_")):
            t = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                times.append((time.perf_counter() - t) * 1e3)

    setattr(obj, method, timed)
