"""Fine-tuning throughput of the flagship's cells: every sample the window's
steps completed over the window's seconds on the host clock (synchronised
at both edges)."""

from pb import readers

NAME, UNIT, TRACE = "train_samples_per_s", "samples/s", 0
CONFIG = "siglip_sequential"


def read(record):
    return readers.samples_per_s(record, CONFIG)
