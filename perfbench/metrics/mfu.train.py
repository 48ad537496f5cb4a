"""The flagship's train step's share of the card's bf16 peak: the model
FLOPs of every sample of the traced window (``pb/work.py:sample_flops``,
from the configuration's shapes, forward and both gradients where
needed, no recomputation) over the window's seconds times the peak."""

from pb import readers

NAME, UNIT, TRACE = "mfu.train", "%", 1
CONFIG = "siglip_sequential"


def read(record):
    return readers.mfu(record, "train", CONFIG)
