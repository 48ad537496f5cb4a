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

The autograd Functions:

- Megatron's conjugate pair around a tensor-parallel region:
  :func:`copy_to_tp` (the identity forward, a sum over the tp group
  backward) goes before a column-parallel projection, whose input every tp
  rank holds whole; :func:`reduce_from_tp` (a sum over the tp group
  forward, the identity backward) goes after a row-parallel one, whose
  output is partial on each tp rank;
- the pair around work that a group of ranks holding the same tensor
  splits among themselves (the ep ranks' share of their tokens, the sp
  ranks' chunks of a sequence): :func:`split_to_group` (this rank's chunk
  forward; the chunks' gradients gathered backward, so every rank holds
  the whole gradient again) and :func:`gather_from_group` (the chunks
  gathered forward; this rank's chunk of the gradient backward: every rank
  computes the same loss from the gathered tensor, so each chunk's one
  cotangent is its owner's);
- :func:`all_to_all` over a group, with row counts per rank, whose
  backward is the reverse all_to_all.

Point to point: :func:`send` and :func:`recv` between two global ranks
(the pipeline's stage to stage transfers, whose backward sends the
gradient back: :mod:`~bifold_tpu_torch.parallel.pipeline` runs both
directions in its own schedule), and :func:`ring_shift`, each rank's
tensor to the next rank of a group and the previous rank's to it (the
ring of :mod:`~bifold_tpu_torch.ops.ring_attention`).

Every collective of the port goes through this module, so one place can
record them: inside :func:`recording`, each call that moves data over a
group of more than one rank appends a :class:`Collective` (its kind, the
bytes of its result on this rank and the group's size), from the tensors'
metadata alone: recording adds no synchronisation, and outside
:func:`recording` nothing is kept. :func:`summarize` folds a record into
per-kind counts, result bytes and wire bytes (:func:`wire_bytes`, the ring
formulas of bifold_tpu/parallel/advisor.py:76-96).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["world_size", "rank", "all_reduce_sum_", "all_reduce_sum",
           "all_reduce_values", "all_gather", "reduce_scatter", "copy_to_tp",
           "reduce_from_tp", "group_size", "SELF", "TPGroup", "broadcast_",
           "send", "recv", "ring_shift", "all_to_all", "split_to_group",
           "gather_from_group", "chunk_bounds", "reduce_step_values",
           "broadcast_object", "Collective", "recording", "summarize", "wire_bytes",
           "KINDS"]

# the group of one rank: collectives over it are the identity
SELF = "self"

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send/recv",
         "broadcast")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One recorded collective: its kind (one of :data:`KINDS`), the bytes
    of its result on this rank (the gathered tensor of an all-gather, this
    rank's chunk of a reduce-scatter, the rows received by an all-to-all or
    a receive, the tensor otherwise) and the size of its group."""

    kind: str
    result_bytes: int
    group: int


_RECORD: Optional[List[Collective]] = None


@contextlib.contextmanager
def recording():
    """Record the collectives called inside: yields the list they are
    appended to, in call order (nested uses share the outer list)."""
    global _RECORD
    outer = _RECORD
    _RECORD = [] if outer is None else outer
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _note(kind: str, nbytes: int, group: int) -> None:
    if _RECORD is not None and group > 1:
        _RECORD.append(Collective(kind, int(nbytes), int(group)))


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, result_bytes: int, group: int) -> int:
    """Bytes one rank sends over its links for one ring-algorithm
    collective, from the bytes of its result (bifold_tpu/parallel/advisor.py
    ``_wire_bytes``): an all-gather (g - 1)/g of the gathered tensor, a
    reduce-scatter (g - 1) chunks, an all-reduce twice (g - 1)/g of the
    tensor, an all-to-all (g - 1)/g of it; a send/recv or a broadcast its
    result once."""
    g = group
    if g <= 1:
        return 0
    if kind == "all-gather":
        return result_bytes * (g - 1) // g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) // g
    if kind == "all-to-all":
        return result_bytes * (g - 1) // g
    return result_bytes


def summarize(record: Sequence[Collective]) -> Dict[str, Dict[str, int]]:
    """``{kind: {"count", "result_bytes", "wire_bytes"}}`` of a record, the
    shape of the JAX advisor's ``collectives`` entry."""
    out: Dict[str, Dict[str, int]] = {}
    for c in record:
        agg = out.setdefault(c.kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0})
        agg["count"] += 1
        agg["result_bytes"] += c.result_bytes
        agg["wire_bytes"] += wire_bytes(c.kind, c.result_bytes, c.group)
    return out


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
    n = group_size(group)
    if n == 1:
        return t
    _note("all-reduce", _bytes(t), n)
    return _all_reduce(t, group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
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
    _note("all-gather", n * _bytes(t), n)
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
    _note("reduce-scatter", _bytes(t) // n, n)
    if dist.get_backend(group) == dist.Backend.GLOO:
        full = _all_reduce(t.contiguous().clone(), group)
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


def reduce_step_values(grads, loss, inter, group=None):
    """Sum the gradients, the loss and its terms (a dict of scalars) over
    the ranks of ``group`` in one flat float32 buffer (one collective);
    returns them in their shapes and dtypes."""
    values = [loss.detach().float().reshape(1)] + [
        v.detach().float().reshape(1) for v in inter.values()]
    flat = all_reduce_sum_(torch.cat([g.float().reshape(-1) for g in grads] + values),
                           group)
    parts = flat.split([g.numel() for g in grads] + [1] * len(values))
    grads = [p.view(g.shape).to(g.dtype) for p, g in zip(parts, grads)]
    scalars = [p[0] for p in parts[len(grads):]]
    return grads, scalars[0], dict(zip(inter, scalars[1:]))


def _global(group, index: int) -> int:
    """The global rank of ``group``'s ``index``-th rank."""
    return index if group is None else dist.get_global_rank(group, index)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of ``group``'s rank ``src`` (its index in the group) on every
    rank of the group, in place. Returns ``t``."""
    n = group_size(group)
    if n == 1:
        return t
    _note("broadcast", _bytes(t), n)
    root = _global(group, src)
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, root, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, root, group=group)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of the global rank ``src`` (any picklable object) on every
    rank of the default group. Recorded as a broadcast of its pickle."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    if _RECORD is not None:
        _note("broadcast", len(pickle.dumps(box[0])), world_size())
    return box[0]


def send(t: torch.Tensor, dst: int, tag: int = 0):
    """Start sending ``t`` to the global rank ``dst`` over the default group;
    returns the handle to ``wait()`` on (which keeps the staged host copy
    of a CUDA tensor under gloo alive until then). The transfer is recorded
    once, by the receiving rank (:func:`recv`)."""
    src = t.contiguous()
    host = src.cpu() if _staged(src, None) else src
    work = dist.isend(host, dst, tag=tag)
    return _Pending(work, host)


def recv(shape, dtype, device, src: int, tag: int = 0) -> torch.Tensor:
    """A new tensor of ``shape`` and ``dtype`` on ``device``, received from
    the global rank ``src`` over the default group (blocking)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    _note("send/recv", _bytes(out), 2)
    host = out.cpu() if _staged(out, None) else out
    dist.recv(host, src, tag=tag)
    return out.copy_(host) if host is not out else out


@dataclasses.dataclass
class _Pending:
    work: Any
    buffer: torch.Tensor

    def wait(self) -> None:
        self.work.wait()


def ring_shift(tensors: Sequence[torch.Tensor], ranks: Sequence[int],
               me: int) -> list:
    """Each of ``tensors`` sent to the next rank of the ring ``ranks``
    (global ranks in ring order; ``me`` this rank's index) and replaced by
    the previous rank's: new tensors, contiguous, of the same shapes and
    dtypes. The sends start before the receives block, so every rank
    posts both at once."""
    n = len(ranks)
    if n == 1:
        return [t.contiguous() for t in tensors]
    nxt, prev = ranks[(me + 1) % n], ranks[(me - 1) % n]
    pending = [send(t, nxt, tag=i) for i, t in enumerate(tensors)]
    out = [recv(t.shape, t.dtype, t.device, prev, tag=i) for i, t in enumerate(tensors)]
    for p in pending:
        p.wait()
    return out


def _all_to_all_rows(x: torch.Tensor, send_rows: Sequence[int],
                     recv_rows: Sequence[int], group) -> torch.Tensor:
    out = torch.empty((sum(recv_rows), *x.shape[1:]), dtype=x.dtype, device=x.device)
    _note("all-to-all", _bytes(out), len(recv_rows))
    src = x.contiguous()
    if _staged(src, group):
        host_out = torch.empty(out.shape, dtype=out.dtype)
        dist.all_to_all_single(host_out, src.cpu(), list(recv_rows), list(send_rows),
                               group=group)
        return out.copy_(host_out)
    dist.all_to_all_single(out, src, list(recv_rows), list(send_rows), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_rows, recv_rows, group):
        ctx.rows, ctx.group = (send_rows, recv_rows), group
        return _all_to_all_rows(x, send_rows, recv_rows, group)

    @staticmethod
    def backward(ctx, grad):
        send_rows, recv_rows = ctx.rows
        return _all_to_all_rows(grad, recv_rows, send_rows, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, send_rows: Sequence[int], group,
               recv_rows: Optional[Sequence[int]] = None):
    """Rows of ``x`` (dim 0) sent over ``group``: the first ``send_rows[0]``
    to its rank 0, the next ``send_rows[1]`` to rank 1, ...; returns (the
    rows received, in the senders' rank order, and ``recv_rows``, how many
    came from each). Without ``recv_rows`` the counts are exchanged first
    (a small all_to_all). Differentiable: the backward sends each row's
    gradient back the reverse way."""
    n = group_size(group)
    if n == 1:
        return x, [x.shape[0]]
    send_rows = [int(r) for r in send_rows]
    if recv_rows is None:
        counts = torch.tensor(send_rows, dtype=torch.int64)
        got = torch.empty_like(counts)
        if dist.get_backend(group) == dist.Backend.NCCL:
            counts, got = counts.to(x.device), got.to(x.device)
        _note("all-to-all", _bytes(got), n)
        dist.all_to_all_single(got, counts, group=group)
        recv_rows = [int(r) for r in got.tolist()]
    return _AllToAll.apply(x, tuple(send_rows), tuple(recv_rows), group), recv_rows


def chunk_bounds(length: int, n: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of chunk ``i`` of ``length`` cut into ``n`` as
    ``torch.tensor_split`` cuts it (the first ``length % n`` chunks one
    longer): the chunk :func:`split_to_group` gives rank ``i``."""
    base, extra = divmod(length, n)
    lo = i * base + min(i, extra)
    return lo, lo + base + (i < extra)


def _gather_chunks(chunk: torch.Tensor, length: int, dim: int, group) -> torch.Tensor:
    """The ranks' chunks of a dim of ``length`` (cut as
    :func:`chunk_bounds` cuts it) concatenated along ``dim``; the shorter
    chunks are padded to the first one's size for the all-gather."""
    n = group_size(group)
    sizes = [hi - lo for lo, hi in (chunk_bounds(length, n, i) for i in range(n))]
    moved = chunk.movedim(dim, 0)
    pad = sizes[0] - moved.shape[0]
    if pad:
        moved = torch.cat([moved, moved.new_zeros((pad, *moved.shape[1:]))])
    parts = all_gather(moved, group).chunk(n)
    return torch.cat([p[:size] for p, size in zip(parts, sizes)]).movedim(0, dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, me = group_size(group), dist.get_rank(group)
        lo, hi = chunk_bounds(x.shape[dim], n, me)
        ctx.dim, ctx.group, ctx.length = dim, group, x.shape[dim]
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_chunks(grad.contiguous(), ctx.length, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, dim, length, group):
        ctx.dim, ctx.group = dim, group
        ctx.bounds = chunk_bounds(length, group_size(group), dist.get_rank(group))
        return _gather_chunks(chunk.contiguous(), length, dim, group)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.bounds
        return grad.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None, None


def split_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (``x`` the same on every
    rank of ``group``, cut as ``torch.tensor_split`` cuts it); its gradient
    is the chunks' gradients gathered over the group."""
    if group_size(group) == 1:
        return x
    return _Split.apply(x, dim, group)


def gather_from_group(chunk: torch.Tensor, dim: int, length: int, group) -> torch.Tensor:
    """The ranks' chunks (of :func:`split_to_group`'s cut of a dim of
    ``length``) concatenated along ``dim``, on every rank; the gradient of
    this rank's chunk is its slice of the gathered tensor's gradient."""
    if group_size(group) == 1:
        return chunk
    return _Gather.apply(chunk, dim, length, group)
