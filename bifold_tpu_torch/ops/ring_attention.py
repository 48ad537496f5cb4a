"""Ring attention: the sequence cut over the ``sp`` ranks, k and v passed around.

Counterpart of bifold_tpu/ops/ring_attention.py (``_ring_fwd_pass`` :70,
``_ring_shard_bwd`` :112, ``ring_attention`` :144). Each rank of the sp
group holds a chunk of the queries and starts with the same chunk of the
keys, values and key mask; the chunks of k, v and the mask go round the
ring (:func:`~bifold_tpu_torch.parallel.collectives.ring_shift`, rank ``i``
to ``i + 1``), so every query chunk meets every key chunk once:

- forward: each ring step launches the flash forward with lse
  (:func:`~bifold_tpu_torch.ops.flash_attention.flash_attention_fwd`) on
  (q chunk, visiting k, v, mask) and merges the partial into an f32
  accumulator by ``logaddexp`` weights; the merged row lse is the global
  one. A fully masked key chunk (the context frames' padding can mask one)
  has a finite lse, about -1e5 + log n (the kernels fill masked scores
  with -1e5), so its merge weight is exp(-1e5 - ...) = 0, as JAX relies on;
- backward: a second ring. Each step launches the flash backward
  (:func:`~bifold_tpu_torch.ops.flash_attention.flash_attention_bwd`) with
  the *global* output and lse, which makes each chunk's partial gradients
  exact; dq accumulates in f32 on its rank, dk and dv accumulate in f32 and
  ride the ring with their chunk, arriving home complete after ``sp`` steps.

On a CUDA tensor every step launches the kernels or raises; on the CPU the
kernels' plain versions run. The calls go straight to the kernels, so
``ops/attention.py``'s 256-token threshold does not apply (the flagship's
chunks of 192 or 288 tokens take the kernels); received chunks land in
fresh contiguous buffers, which keep the kernels' 16-byte row rule. JAX's
model never calls the ring, and neither does the port's: it is the
primitive both packages export (``parallel.ring_attention``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bifold_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
from bifold_tpu_torch.parallel.collectives import (gather_from_group, ring_shift,
                                                   split_to_group)

__all__ = ["ring_attention", "ring_attention_shard"]


def _merge(lse_acc, lse_c):
    """(merged lse, weight of the accumulator, weight of the partial)."""
    lse = torch.logaddexp(lse_acc, lse_c)
    return lse, torch.exp(lse_acc - lse), torch.exp(lse_c - lse)


def _rows(w):
    # (b, h, nq) row weights -> (b, nq, h, 1), broadcast over the outputs
    return w.transpose(1, 2)[..., None]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, ranks, me, scale):
        b, nq, h, d = q.shape
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        sp = len(ranks)
        out = torch.zeros((b, nq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, nq), float("-inf"), dtype=torch.float32, device=q.device)
        kc, vc, mc = k, v, mask
        for step in range(sp):
            o_c, lse_c = flash_attention_fwd(q, kc, vc, mc, scale=scale)
            lse, w_acc, w_c = _merge(lse, lse_c)
            out = out * _rows(w_acc) + o_c.float() * _rows(w_c)
            if step < sp - 1:
                kc, vc, mc = _shift([kc, vc, mc], ranks, me)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.ring, ctx.scale = (ranks, me), scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        ranks, me = ctx.ring
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kc, vc, mc = k, v, mask
        for step in range(len(ranks)):
            dq_c, dk_c, dv_c = flash_attention_bwd(q, kc, vc, mc, out, lse, g,
                                                   scale=ctx.scale)
            dq += dq_c.float()
            dk += dk_c.float()
            dv += dv_c.float()
            # dk and dv travel with their chunk and are home after the last
            # step; k, v and the mask need not make that last move
            if step < len(ranks) - 1:
                kc, vc, mc, dk, dv = _shift([kc, vc, mc, dk, dv], ranks, me)
            else:
                dk, dv = _shift([dk, dv], ranks, me)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def _shift(tensors, ranks, me):
    """:func:`ring_shift` of the tensors that are not None."""
    moved = iter(ring_shift([t for t in tensors if t is not None], ranks, me))
    return [None if t is None else next(moved) for t in tensors]


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_mask: Optional[torch.Tensor], *, ranks: Sequence[int],
                         me: int, scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's query chunk (B, N/sp, H, D) over the whole
    sequence, the sp group ``ranks`` (global ranks in ring order, ``me``
    this rank's index) each holding the same-numbered chunk of k, v and
    ``key_mask`` (B, N/sp) int32 or None; differentiable (module doc). The
    forward launches ``sp`` flash forwards with lse, the backward ``sp``
    flash backwards."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    return _Ring.apply(q, k, v, key_mask, list(ranks), int(me), float(scale))


def ring_attention(q, k, v, key_mask=None, *, mesh, axis: str = "sp",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over (B, N, H, D) -> the same shape, as
    JAX's ``ring_attention``: ``q``, ``k``, ``v`` (and ``key_mask`` (B,
    N)) are the whole tensors, the same on every rank of ``mesh``'s
    ``axis`` group; each rank computes its chunk of the queries through
    the ring (:func:`ring_attention_shard`) and the chunks are gathered.
    Differentiable; the input gradients come out whole on every rank.
    Raises, as JAX does, for cross-length attention or a sequence the
    axis does not divide."""
    sp = mesh.shape[axis]
    n = q.shape[1]
    if k.shape[1] != n:
        raise ValueError(f"ring_attention: cross-length attention unsupported "
                         f"(nq {n} != nk {k.shape[1]})")
    if n % sp:
        raise ValueError(f"ring_attention: sequence length {n} not divisible by "
                         f"{axis}={sp}")
    group, me = mesh.groups[axis], mesh.coords[axis]
    if key_mask is not None:
        key_mask = key_mask.narrow(1, me * (n // sp), n // sp)
    parts = [split_to_group(t, 1, group) for t in (q, k, v)]
    out = ring_attention_shard(*parts, key_mask, ranks=mesh.ranks[axis], me=me,
                               scale=scale)
    return gather_from_group(out, 1, n, group)
