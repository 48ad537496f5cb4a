"""The flash inference kernel's share of its roofline in a served call: the
sum of each launch's least time (``pb/work.py:flash_launch`` and ``bound``,
bf16, masked keys not counted) over the profiler's device time of the
kernels named in ``KERNELS``."""

from pb import readers

NAME, UNIT, TRACE = "flash_serve_roofline", "%", 1
KINDS = ("fwd_infer",)
KERNELS = ("flash_fwd_mma",)


def read(record):
    return readers.roofline(record, "serve", KINDS, KERNELS)
