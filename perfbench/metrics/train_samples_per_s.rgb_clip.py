"""Fine-tuning throughput of rgb_clip's cells, as ``train_samples_per_s``;
a metric of its own so that each configuration's spread sets its bound."""

from pb import readers

NAME, UNIT, TRACE = "train_samples_per_s.rgb_clip", "samples/s", 0
CONFIG = "rgb_clip"


def read(record):
    return readers.samples_per_s(record, CONFIG)
