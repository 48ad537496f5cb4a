"""The card's side of a run: synchronise, free, and the program's peak."""

from __future__ import annotations

import gc

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reset_peak(device) -> None:
    """Free what the benchmark made on the card and start the peak anew:
    from here the peak is the program's."""
    free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
