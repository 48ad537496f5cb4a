"""The share of the traced serving window in which no operation ran on the
card: 1 - (the union of device intervals) / the window."""

from pb import readers

NAME, UNIT, TRACE = "idle_share.serve", "%", 1


def read(record):
    return readers.idle_share(record, "serve")
