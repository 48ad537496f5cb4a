"""The share of the flagship's traced train window in which no operation ran
on the card: 1 - (the union of device intervals) / the window."""

from pb import readers

NAME, UNIT, TRACE = "idle_share.train", "%", 1
CONFIG = "siglip_sequential"


def read(record):
    return readers.idle_share(record, "train", CONFIG)
