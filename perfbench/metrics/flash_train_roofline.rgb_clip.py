"""The flash kernels' share of their roofline in rgb_clip's train step (head
dim 32), as ``flash_train_roofline``."""

from pb import readers

NAME, UNIT, TRACE = "flash_train_roofline.rgb_clip", "%", 1
CONFIG = "rgb_clip"
KINDS = ("fwd_lse", "bwd")
KERNELS = ("flash_fwd_mma", "dkdv_mma", "dq_mma")


def read(record):
    return readers.roofline(record, "train", KINDS, KERNELS, CONFIG)
