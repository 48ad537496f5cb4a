"""rgb_clip's train step's share of the card's bf16 peak, as ``mfu.train``."""

from pb import readers

NAME, UNIT, TRACE = "mfu.train.rgb_clip", "%", 1
CONFIG = "rgb_clip"


def read(record):
    return readers.mfu(record, "train", CONFIG)
