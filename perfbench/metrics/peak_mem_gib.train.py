"""The flagship's train peak of allocated device memory
(``torch.cuda.max_memory_allocated``), set-up and window."""

from pb import readers

NAME, UNIT, TRACE = "peak_mem_gib.train", "GiB", 1
CONFIG = "siglip_sequential"


def read(record):
    return readers.peak_gib(record, "train", CONFIG)
