"""What the metric files read from a run's record, in one place.

Each function returns None where the record has nothing to read (another
kind of entry, an untraced run, no launches of the kernels named), never
0 for a share. A metric file (``metrics/<name>.py``) names the kind and,
where its bound is a configuration's own, the configuration it reads in.
"""

from __future__ import annotations

from pb.roofline import share
from pb.work import card_peaks


def _of(record, kind, config=None) -> bool:
    return record.get("kind") == kind and (config is None or record.get("config") == config)


def samples_per_s(record, config=None):
    """Every sample the window's steps completed over the window's seconds."""
    if not _of(record, "train", config) or not record.get("window_s"):
        return None
    return record["samples"] / record["window_s"]


def mfu(record, kind, config=None):
    """Model FLOPs of the traced window over its seconds times the bf16 peak, %."""
    if not _of(record, kind, config) or not record.get("window_s") or not record.get("flops"):
        return None
    return 100.0 * record["flops"] / (record["window_s"] * card_peaks(record.get("card", ""))[0])


def idle_share(record, kind, config=None):
    """1 - (the union of device intervals) / the traced window, %."""
    if not _of(record, kind, config) or not record.get("window_s") or "busy_s" not in record:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def peak_gib(record, kind, config=None):
    """The program's peak of allocated device memory, GiB."""
    if not _of(record, kind, config) or not record.get("memory_peak_bytes"):
        return None
    return record["memory_peak_bytes"] / 2 ** 30


def roofline(record, kind, kinds, kernels, config=None):
    """The flash kernels' share of their roofline (``pb/roofline.py``), %."""
    if not _of(record, kind, config):
        return None
    return share(record, kinds, kernels)
