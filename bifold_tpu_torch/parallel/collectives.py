"""The collectives of the parallel paths, over ``torch.distributed`` groups.

Every reduction is a SUM over the ranks of a group: the default group when
none is named, else a group of the mesh (:func:`bifold_tpu_torch.parallel
.make_mesh`). ``group=None`` means the default group, :data:`SELF` a group
of one (the collective is the identity and nothing is sent). A NCCL group
works on CUDA tensors where they lie; a gloo group works on CPU tensors,
and a CUDA tensor handed to a gloo group is staged through host memory
(copied out, reduced or gathered, copied back): a choice by backend, made
here and nowhere else. Without a group (or in a group of one)
:func:`world_size` is 1 and callers skip these.

The two autograd Functions are Megatron's conjugate pair around a
tensor-parallel region: :func:`copy_to_tp` (the identity forward, a sum over
the tp group backward) goes before a column-parallel projection, whose
input every tp rank holds whole; :func:`reduce_from_tp` (a sum over the tp
group forward, the identity backward) goes after a row-parallel one, whose
output is partial on each tp rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["world_size", "rank", "all_reduce_sum_", "all_reduce_sum",
           "all_reduce_values", "all_gather", "reduce_scatter", "copy_to_tp",
           "reduce_from_tp", "group_size", "SELF", "TPGroup"]

# the group of one rank: collectives over it are the identity
SELF = "self"


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """A tp group as the modules that compute a tp shard see it: the
    group, its size and this rank's place in it."""

    group: Any
    size: int
    rank: int

    def part(self, t: torch.Tensor, axis: int = 0, blocks: int = 1) -> torch.Tensor:
        """This rank's part of ``t`` along ``axis``: the ``rank``-th of
        ``size`` equal parts of each of ``blocks`` equal blocks (q, k and v
        of a fused projection are 3 blocks)."""
        if blocks == 1:
            n = t.shape[axis] // self.size
            return t.narrow(axis, self.rank * n, n)
        return torch.cat([b.chunk(self.size, axis)[self.rank]
                          for b in t.chunk(blocks, axis)], axis)


def world_size() -> int:
    """The size of the default group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def group_size(group=None) -> int:
    """The ranks of ``group`` (the default group for None; 1 for
    :data:`SELF` or without a process group)."""
    if group is SELF or not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place (the caller's stream
    waits for a NCCL reduction before it goes on). Returns ``t``."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0, in rank
    order of ``group``: a new tensor."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    src = t.contiguous()
    host = src.cpu() if _staged(src, group) else src
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(t.device)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk ``i`` (of ``group``'s size, along dim 0) of the sum over the
    ranks of ``t``, on the rank ``i`` of ``group``: a new tensor. gloo has no
    reduce-scatter on every torch version, so a gloo group reduces all of it
    and keeps its chunk (the same sum, in the same order, on every rank)."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} does not "
                         f"divide over {n} ranks")
    me = dist.get_rank(group)
    if dist.get_backend(group) == dist.Backend.GLOO:
        full = all_reduce_sum_(t.contiguous().clone(), group)
        return full.chunk(n)[me].clone()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of every rank's x is the sum
    over ranks of the gradients of y (each rank's loss depends on the
    global y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks of ``group`` (a new
    tensor)."""
    return _AllReduceSum.apply(x, group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (the tp ranks'
    partial input gradients of a column-parallel projection)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the tp ranks' partial outputs of a
    row-parallel projection); its gradient passed through."""
    return _ReduceFromTP.apply(x, group)


def all_reduce_values(values: Sequence[float], group=None) -> np.ndarray:
    """Host numbers summed over the ranks of ``group``, in float64, through
    a tensor on the group's device (the current CUDA device for NCCL, else
    the CPU)."""
    if group_size(group) == 1:
        return np.asarray(values, dtype=np.float64)
    device = ("cuda" if dist.get_backend(group) == dist.Backend.NCCL else "cpu")
    t = torch.tensor(np.asarray(values, dtype=np.float64), device=device)
    return all_reduce_sum_(t, group).cpu().numpy()

