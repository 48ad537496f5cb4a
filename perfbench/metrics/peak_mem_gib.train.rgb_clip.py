"""rgb_clip's train peak of allocated device memory, as ``peak_mem_gib.train``."""

from pb import readers

NAME, UNIT, TRACE = "peak_mem_gib.train.rgb_clip", "GiB", 1
CONFIG = "rgb_clip"


def read(record):
    return readers.peak_gib(record, "train", CONFIG)
