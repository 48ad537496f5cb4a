"""The train and eval steps, on one device.

Counterpart of bifold_tpu/parallel/__init__.py:330-432 (``make_train_step``)
and :489 (``make_eval_step``) for a single device; the data/FSDP/tensor/
pipeline modes are not ported, and :func:`check_mesh` refuses a ``mesh``
config that asks for them.

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
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from bifold_tpu_torch.models.dropout import set_dropout_generator
from bifold_tpu_torch.optim import Optimizer

__all__ = ["TrainState", "make_train_step", "make_eval_step", "check_mesh",
           "MESH_AXES"]

MESH_AXES = ("dcn", "dp", "fsdp", "tp", "pp", "sp", "ep")


def check_mesh(mesh_cfg) -> None:
    """Raise unless ``mesh_cfg`` (the config's ``mesh`` node) asks for one
    device: every axis 1, or ``dp: -1`` ("all devices"), which is one here;
    ``pp_microbatches`` has no effect without pipeline stages."""
    node = dict(mesh_cfg or {})
    node.pop("pp_microbatches", None)
    unknown = set(node) - set(MESH_AXES)
    if unknown:
        raise KeyError(f"unknown mesh axes {sorted(unknown)} (have {MESH_AXES})")
    wide = {k: v for k, v in node.items() if v != 1 and not (k == "dp" and v == -1)}
    if wide:
        raise NotImplementedError(
            f"mesh {wide}: the port trains on one device; meshes of more than one "
            "device are ROADMAP queue item 5")


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


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: Optimizer, *,
                    moe_aux_weight: float = 0.0) -> Callable:
    """The train step over ``optimizer.params`` (the trainable parameters)."""
    params = optimizer.params
    device = params[0].device
    buffers = list(model.buffers())

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.key))
        model.train()
        set_dropout_generator(model, torch.Generator(device).manual_seed(seed))
        before = [b.clone() for b in buffers]
        try:
            out = dict(model(batch))
            moe_losses = out.pop("moe_losses", None)
            loss, inter = loss_fn(out, batch)
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
