"""The served forward's share of the card's bf16 peak: the model FLOPs of
every observation of the traced window over its seconds times the peak."""

from pb import readers

NAME, UNIT, TRACE = "mfu.serve", "%", 1


def read(record):
    return readers.mfu(record, "serve")
