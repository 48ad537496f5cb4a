"""The flash kernels' share of their roofline in the flagship's train step:
each launch's least time (``pb/work.py:flash_launch`` and ``bound``: the
forward with lse and the backward, bf16, masked keys not counted) over
the profiler's device time of the kernels named in ``KERNELS``."""

from pb import readers

NAME, UNIT, TRACE = "flash_train_roofline", "%", 1
CONFIG = "siglip_sequential"
KINDS = ("fwd_lse", "bwd")
KERNELS = ("flash_fwd_mma", "dkdv_mma", "dq_mma")


def read(record):
    return readers.roofline(record, "train", KINDS, KERNELS, CONFIG)
