"""rgb_clip's idle share of its traced train window, as ``idle_share.train``."""

from pb import readers

NAME, UNIT, TRACE = "idle_share.train.rgb_clip", "%", 1
CONFIG = "rgb_clip"


def read(record):
    return readers.idle_share(record, "train", CONFIG)
