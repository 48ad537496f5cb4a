"""The train and eval steps, on one device or data-parallel over
``torch.distributed``.

Counterpart of bifold_tpu/parallel/__init__.py: ``distributed_init`` (:58),
the data axes of ``make_mesh`` (:126; :func:`check_mesh`), ``shard_batch``
(:287), ``make_train_step`` (:330) and ``make_eval_step`` (:491). Under JAX
SPMD a dp step over N devices *is* the single-device step on the global
batch; the port keeps that meaning with one process per device, each
holding a contiguous slice of the global batch:

- the gradients of the trainable parameters are summed over the ranks in
  one flat buffer, after the backward, on the compute stream (no overlap
  with the backward), together with the loss and its per-head terms;
- each loss term says how it reduces over the batch: a mean term is scaled
  by local / global batch (``batch_share``), a sum term is left as it is,
  so the sums over ranks are the global batch's loss and gradient;
- BatchNorm's train-mode statistics are global (:mod:`~bifold_tpu_torch
  .models.norm`), so the running statistics move as in one process;
- clipping and the optimizer then see identical gradients on every rank,
  and the parameters stay replicated;
- each rank draws its dropout masks from (step seed, rank); rank 0 from the
  step seed itself, so a group of one steps exactly as no group does.

The fsdp, tp, pp, sp and ep axes, and MoE layers under a group of more than
one rank (JAX routes tokens over the global batch), are not ported and
raise, naming the step of ROADMAP queue item 5 that holds each.

``step(state, batch) -> (state, metrics)``: the model runs in ``train()``
mode on the processed batch with a dropout generator made fresh for this
step from the state's key generator (JAX splits a fresh dropout key per step
the same way), the loss is differentiated with respect to the trainable
parameters only (the optimizer's, ``requires_grad``; frozen towers get no
gradient and no dW work), and the optimizer updates them in place. Metrics
are device tensors, read by the caller when it needs them: ``loss``,
``grad_norm`` and ``grad_norm_trainable`` (the same value here: frozen
parameters carry no gradient), and the loss's per-head terms. A model with
MoE layers hands back their load-balance losses as ``moe_losses`` in its
train-mode output; with ``moe_aux_weight`` their mean, times the weight, is
added to the loss and reported as ``moe_load_balance``
(bifold_tpu/parallel/__init__.py:383-392).

BatchNorm running statistics (``text_unet``) move in the train-mode
forward, in place, on every step, whatever the optimizer does with its
gradients (JAX merges the mutated ``batch_stats`` unconditionally). A step
that raises before its optimizer update (an interrupt during the forward or
backward) puts them back, so that they never run ahead of the weights.

``eval_step(batch) -> output``: the model in ``eval()`` mode under
``torch.inference_mode()`` (no dropout, no autograd graph, so attention
takes the inference kernel), its previous mode restored afterwards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from bifold_tpu_torch.models.dropout import set_dropout_generator
from bifold_tpu_torch.optim import Optimizer
from bifold_tpu_torch.parallel.collectives import (all_reduce_sum_, all_reduce_values,
                                                   rank, world_size)

__all__ = ["TrainState", "make_train_step", "make_eval_step", "check_mesh",
           "distributed_init", "shard_batch", "world_size", "rank",
           "all_reduce_values", "MESH_AXES"]

MESH_AXES = ("dcn", "dp", "fsdp", "tp", "pp", "sp", "ep")
# the axes not ported yet, each with the step of ROADMAP queue item 5 that
# holds it
_HELD = {"fsdp": "fsdp/tp, the step after dp", "tp": "fsdp/tp, the step after dp",
         "pp": "pipeline parallelism", "sp": "ring attention (sequence parallelism)",
         "ep": "expert parallelism"}
_MOE_UNDER_DP = ("MoE layers under data parallelism: JAX routes tokens over the "
                 "global batch (capacity and slots over all tokens), a per-rank "
                 "dispatch would drop other tokens; ROADMAP queue item 5, expert "
                 "parallelism")


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     *, device=None, backend: Optional[str] = None) -> bool:
    """Join the default ``torch.distributed`` group: True once a group is up
    (a second call changes nothing), False, doing nothing, for a single
    process (no arguments and no launcher environment).

    Explicit arguments win; otherwise torchrun's environment:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``tcp://addr:port``),
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``. The device is ``device``, else
    ``cuda:LOCAL_RANK`` (which must exist), and a CUDA device becomes the
    current one (so ``"cuda"`` means it from here on); the backend
    ``backend``, else NCCL for a CUDA device and gloo for the CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"distributed_init: init_method={init_method!r}, "
                         f"world_size={world_size!r}, rank={rank!r}; all three "
                         "are needed (arguments or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    if device is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"distributed_init: {device} requested, "
                               f"{torch.cuda.device_count()} CUDA devices here")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def check_mesh(mesh_cfg, *, world: Optional[int] = None, moe_experts: int = 0) -> int:
    """The number of data shards the config's ``mesh`` node asks for, over a
    group of ``world`` ranks (the default group's size): ``dp: -1`` takes
    the ranks that ``dcn`` leaves, and ``dcn x dp`` must equal the ranks.
    ``dcn`` is the slower data axis: with ranks laid out by node
    (``LOCAL_WORLD_SIZE`` ranks each, as torchrun lays them), ``dp`` must
    be a multiple of it, so no node straddles two dcn groups. The other
    axes must be 1, and MoE layers need a group of one; each refusal names
    its step of ROADMAP queue item 5. ``pp_microbatches`` has no effect
    without pipeline stages."""
    world = world_size() if world is None else world
    node = dict(mesh_cfg or {})
    node.pop("pp_microbatches", None)
    unknown = set(node) - set(MESH_AXES)
    if unknown:
        raise KeyError(f"unknown mesh axes {sorted(unknown)} (have {MESH_AXES})")
    for axis, step in _HELD.items():
        if int(node.get(axis, 1)) != 1:
            raise NotImplementedError(
                f"mesh {axis}={node[axis]}: the port shards only the batch "
                f"(dcn, dp); {axis} is ROADMAP queue item 5, {step}")
    dcn, dp = int(node.get("dcn", 1)), int(node.get("dp", -1))
    if dp == -1:
        if dcn < 1 or world % dcn:
            raise ValueError(f"mesh dcn={dcn} does not divide {world} ranks")
        dp = world // dcn
    if dcn * dp != world:
        raise ValueError(f"mesh dcn x dp = {dcn} x {dp} != {world} ranks")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dp) or dp)
    if dcn > 1 and dp % local:
        raise ValueError(f"mesh dp={dp} is not a multiple of the {local} ranks "
                         "of a node (LOCAL_WORLD_SIZE): a node would straddle "
                         "two dcn groups")
    if world > 1 and moe_experts:
        raise NotImplementedError(f"moe_experts={moe_experts} over {world} ranks: "
                                  + _MOE_UNDER_DP)
    return world


def shard_batch(batch: Dict[str, Any], *, shard: Optional[int] = None,
                shards: Optional[int] = None) -> Dict[str, Any]:
    """Slice ``shard`` (this rank) of a global batch cut into ``shards``
    (the group's size) contiguous equal slices along the batch dimension of
    every tensor or array; other entries (instruction strings,
    ``label_keys``) pass through."""
    shards = world_size() if shards is None else shards
    shard = rank() if shard is None else shard

    def piece(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0:
            if x.shape[0] % shards:
                raise ValueError(
                    f"Batch dim {x.shape[0]} must be divisible by the {shards} "
                    "data-axis shards; adjust batch_size or the mesh config")
            n = x.shape[0] // shards
            return x[shard * n:(shard + 1) * n]
        return x

    return {k: piece(v) for k, v in batch.items()}


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the model's own parameters: the
    optimizer (its moments and update count) and ``key``, a CPU generator
    from which each step draws the seed of its dropout generator."""

    optimizer: Optimizer
    key: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, optimizer: Optimizer, seed: int = 0) -> "TrainState":
        return cls(optimizer, torch.Generator().manual_seed(seed))


def _rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` for a step drawn ``seed``: the step's
    own for rank 0, a distinct one for every other rank."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2 ** 63


def _reduce_over_ranks(grads, loss, inter):
    """Sum the gradients, the loss and its terms over the ranks in one flat
    float32 buffer (one collective); returns them in their shapes."""
    values = [loss.detach().float().reshape(1)] + [
        v.detach().float().reshape(1) for v in inter.values()]
    flat = all_reduce_sum_(torch.cat([g.float().reshape(-1) for g in grads] + values))
    parts = flat.split([g.numel() for g in grads] + [1] * len(values))
    grads = [p.view(g.shape).to(g.dtype) for p, g in zip(parts, grads)]
    scalars = [p[0] for p in parts[len(grads):]]
    return grads, scalars[0], dict(zip(inter, scalars[1:]))


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: Optimizer, *,
                    moe_aux_weight: float = 0.0) -> Callable:
    """The train step over ``optimizer.params`` (the trainable parameters),
    data-parallel over the default group when there is one of more than
    one rank (the batch each rank is given is its slice)."""
    params = optimizer.params
    device = params[0].device
    buffers = list(model.buffers())
    world, me = world_size(), rank()

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.key))
        model.train()
        set_dropout_generator(model, torch.Generator(device).manual_seed(
            _rank_seed(seed, me)))
        before = [b.clone() for b in buffers]
        try:
            out = dict(model(batch))
            moe_losses = out.pop("moe_losses", None)
            if world > 1 and moe_losses is not None:
                raise NotImplementedError(_MOE_UNDER_DP)
            loss, inter = loss_fn(out, batch, batch_share=1.0 / world)
            if moe_aux_weight and moe_losses is not None:
                aux = moe_losses.float().mean()
                loss = loss + moe_aux_weight * aux
                inter = {**inter, "moe_load_balance": aux}
            grads = list(torch.autograd.grad(loss, params))
        except BaseException:
            with torch.no_grad():
                for b, saved in zip(buffers, before):
                    b.copy_(saved)
            raise
        finally:
            set_dropout_generator(model, None)
        if dist.is_initialized():
            grads, loss, inter = _reduce_over_ranks(grads, loss, inter)
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        state.optimizer.step(grads)
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "grad_norm_trainable": gnorm,
                   **{k: v.detach() for k, v in inter.items()}}
        return state, metrics

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """The no-grad forward of ``model`` on a processed batch."""

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return model(batch)
        finally:
            model.train(was_training)

    return step
