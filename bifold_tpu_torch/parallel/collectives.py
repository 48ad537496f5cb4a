"""The collectives of the data-parallel path, over the default
``torch.distributed`` group.

Every reduction is a SUM over the ranks. A NCCL group reduces CUDA tensors
where they lie; a gloo group reduces CPU tensors, and a CUDA tensor handed
to a gloo group is staged through host memory (copied out, reduced, copied
back): a choice by backend, made here and nowhere else. Without a group
(or in a group of one) :func:`world_size` is 1 and callers skip these.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["world_size", "rank", "all_reduce_sum_", "all_reduce_sum",
           "all_reduce_values"]


def world_size() -> int:
    """The size of the default group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (the caller's stream waits for a
    NCCL reduction before it goes on). Returns ``t``."""
    if t.is_cuda and dist.get_backend() == dist.Backend.GLOO:
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of every rank's x is the sum
    over ranks of the gradients of y (each rank's loss depends on the
    global y)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks (a new tensor)."""
    return _AllReduceSum.apply(x)


def all_reduce_values(values: Sequence[float]) -> np.ndarray:
    """Host numbers summed over the ranks, in float64, through a tensor on
    the group's device (the current CUDA device for NCCL, else the CPU)."""
    device = ("cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu")
    t = torch.tensor(np.asarray(values, dtype=np.float64), device=device)
    return all_reduce_sum_(t).cpu().numpy()
