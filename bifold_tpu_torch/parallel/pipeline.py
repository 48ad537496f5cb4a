"""GPipe: a stack's layers cut into ``pp`` stages, fed microbatch by microbatch.

Counterpart of bifold_tpu/parallel/pipeline.py:47 ``gpipe``. JAX writes the
schedule as data flow inside one program (``lax.scan`` over ticks,
``ppermute`` stage to stage) and lets AD transpose it; the port runs one
process per stage and writes both directions out:

- forward (fill and drain): stage 0 takes microbatch ``i`` of the input,
  every other stage receives it from the stage before; each stage runs
  its layers on it and sends the result on; the last stage keeps the
  microbatches' outputs. No stage computes a bubble tick (JAX computes
  them on data nobody uses, and they carry no gradient);
- the output ends on every rank of the pp group (JAX's ``psum`` over
  ``pp`` replicates it): the last stage broadcasts it;
- backward, microbatches in reverse: the last stage takes its own copy of
  the output's cotangent (every pp rank computes the same loss from the
  replicated output, so exactly one copy may enter the pipe, or the
  stage gradients come out pp times too large); each stage runs the
  backward of its layers on one microbatch and sends the input's gradient
  to the stage before; a stage's parameter gradients sum over its
  microbatches; stage 0's input gradient is broadcast to every pp rank
  (the transpose of JAX's replicated input is a ``psum`` over ``pp`` with
  one nonzero term), so the layers before the pipe get it whole on every
  rank.

Stage ``s`` holds layers ``[s * depth / pp, (s + 1) * depth / pp)``
(:mod:`~bifold_tpu_torch.parallel.sharding` cuts the others away). Sends
start without waiting (each is waited on before the pass returns), receives
block; the order of every send and receive is fixed by (microbatch,
direction), so the stages pair up whatever the timing. Activations cross
as they are: every stage keeps its input's shape and dtype (a stack of
residual blocks; each stage checks its own output), so each receive is
sized from the pipe's input, which every rank holds, without a message;
a CUDA tensor over gloo is staged through host memory
(:mod:`~bifold_tpu_torch.parallel.collectives`).

Per-sample side inputs (attention masks) are not sent: every pp rank holds
the whole input, so each stage cuts its own microbatch of them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from bifold_tpu_torch.parallel.collectives import broadcast_, recv, send

__all__ = ["gpipe", "microbatch_count"]



def microbatch_count(batch: int, pp: int, requested: int = 0) -> int:
    """The microbatches of a batch of ``batch`` rows on ``pp`` stages:
    ``requested`` (the config's ``pp_microbatches``), which must divide the
    batch, else gcd(batch, 2 pp), JAX's default
    (bifold_tpu/models/layers.py:621-623). The port cuts each data rank's
    own batch (JAX cuts the global one): the per-sample math does not
    depend on where microbatches are cut."""
    if requested:
        if batch % requested:
            raise ValueError(f"pp_microbatches={requested} does not divide this "
                             f"rank's batch of {batch}")
        return int(requested)
    return math.gcd(batch, 2 * pp)


class _Schedule:
    """One call of :func:`gpipe` on this rank: the body, the side inputs,
    the stage's place in the pipe and the microbatch count."""

    def __init__(self, body, side, ranks: Sequence[int], stage: int, group,
                 microbatches: int, input_grad: bool):
        self.body, self.side = body, side
        self.ranks, self.stage, self.group = list(ranks), stage, group
        self.m, self.input_grad = microbatches, input_grad
        self.last = len(self.ranks) - 1

    def side_of(self, i: int):
        return [None if s is None else s.chunk(self.m)[i] for s in self.side]

    def forward(self, x: torch.Tensor, grad: bool):
        """Run the stage on every microbatch; (inputs, outputs) per
        microbatch, and the whole output on every rank."""
        ins, outs, pending = [], [], []
        self.x_meta = (x.shape, x.dtype)
        for i, xi in enumerate(x.chunk(self.m)):
            if self.stage == 0:
                h = xi.detach() if grad else xi
            else:
                h = recv(xi.shape, x.dtype, x.device, self.ranks[self.stage - 1], tag=2)
            if grad and (self.stage > 0 or self.input_grad):
                h.requires_grad_()
            y = self.body(h, *self.side_of(i))
            if y.shape != xi.shape or y.dtype != x.dtype:
                raise ValueError(f"a pipelined stage maps {tuple(xi.shape)} {x.dtype} to "
                                 f"{tuple(y.shape)} {y.dtype}; a pipe's stages keep "
                                 "their input's shape and dtype")
            if self.stage < self.last:
                pending.append(send(y.detach(), self.ranks[self.stage + 1], tag=2))
            ins.append(h)
            outs.append(y)
        for p in pending:
            p.wait()
        mine = (torch.cat([y.detach() for y in outs]) if self.stage == self.last else
                torch.empty(x.shape, dtype=x.dtype, device=x.device))
        return ins, outs, broadcast_(mine, self.last, self.group)

    def backward(self, ins, outs, gy, params):
        """The stage's backward over the microbatches in reverse: the
        parameters' gradients (summed) and the input's (on every rank)."""
        grads: list = [None] * len(params)
        dxs = [None] * self.m
        pending = []
        gys = gy.chunk(self.m) if self.stage == self.last else None
        for i in reversed(range(self.m)):
            if self.stage == self.last:
                g = gys[i]
            else:
                g = recv(outs[i].shape, outs[i].dtype, gy.device,
                         self.ranks[self.stage + 1], tag=3)
            wrt = ([ins[i]] if ins[i].requires_grad else []) + list(params)
            got = list(torch.autograd.grad(outs[i], wrt, g, allow_unused=True))
            dh = got.pop(0) if ins[i].requires_grad else None
            for k, d in enumerate(got):
                if d is not None:
                    grads[k] = d if grads[k] is None else grads[k] + d
            if self.stage > 0:
                if dh is None:
                    dh = torch.zeros_like(ins[i])
                pending.append(send(dh, self.ranks[self.stage - 1], tag=3))
            else:
                dxs[i] = dh
        for p in pending:
            p.wait()
        if not self.input_grad:
            return None, grads
        shape, dtype = self.x_meta
        dx = (torch.cat([torch.zeros_like(ins[i]) if d is None else d
                         for i, d in enumerate(dxs)]) if self.stage == 0 else
              torch.empty(shape, dtype=dtype, device=gy.device))
        return broadcast_(dx, 0, self.group), grads


class _Pipe(torch.autograd.Function):
    """The pipe as one node of the caller's graph: its inputs are the
    pipe's input and this stage's trainable tensors, so the step's
    ``torch.autograd.grad`` reaches it on every stage. Each microbatch's
    layers are recorded in a graph of their own (forward under
    ``enable_grad``) and differentiated in the backward's schedule."""

    @staticmethod
    def forward(ctx, schedule, x, *params):
        with torch.enable_grad():
            ins, outs, y = schedule.forward(x, grad=True)
        ctx.schedule, ctx.ins, ctx.outs = schedule, ins, outs
        ctx.save_for_backward(*params)
        return y

    @staticmethod
    def backward(ctx, gy):
        params = ctx.saved_tensors
        dx, grads = ctx.schedule.backward(ctx.ins, ctx.outs, gy.contiguous(), params)
        ctx.ins = ctx.outs = None
        return (None, dx, *grads)


def gpipe(body: Callable, stage_params: Sequence[torch.Tensor], x: torch.Tensor, *,
          mesh, microbatches: int, side: Sequence[Optional[torch.Tensor]] = (),
          trainable: Optional[bool] = None) -> torch.Tensor:
    """Run a stack cut into the ``pp`` stages of ``mesh`` over ``x`` as a
    GPipe pipe (module doc); every rank of the pp group calls it alike.

    ``body(h, *side_mb)`` applies this stage's layers to a microbatch ``h``
    (the port's stage is its slice of layers; JAX's ``body`` applies one
    layer of stacked parameters, :mod:`bifold_tpu.parallel.pipeline`).
    ``stage_params``: the trainable tensors ``body`` uses, whose gradients
    the pipe returns. ``x`` (batch, ...) is the same on every rank of the
    group, ``batch % microbatches == 0``; ``side`` are per-sample tensors
    (batch, ...) or None, cut alike. ``trainable``: whether any stage has
    trainable tensors (the same answer on every stage; default: this
    stage's). Returns the output, the same on every rank of the group.
    Differentiable when grad mode is on and ``x`` or a stage's tensors
    require grad; otherwise the forward schedule alone runs."""
    stage = mesh.coords["pp"]
    if x.shape[0] % microbatches:
        raise ValueError(f"gpipe: batch {x.shape[0]} not divisible by "
                         f"microbatches={microbatches}")
    for s in side:
        if s is not None and s.shape[0] != x.shape[0]:
            raise ValueError(f"gpipe: a side input of batch {s.shape[0]} beside "
                             f"x of batch {x.shape[0]}")
    params = [p for p in stage_params if p.requires_grad]
    trainable = bool(params) if trainable is None else trainable
    grad = torch.is_grad_enabled() and (x.requires_grad or trainable)
    schedule = _Schedule(body, list(side), mesh.ranks["pp"], stage, mesh.groups["pp"],
                         microbatches, input_grad=grad and x.requires_grad)
    if not grad:
        return schedule.forward(x, grad=False)[2]
    return _Pipe.apply(schedule, x, *params)
