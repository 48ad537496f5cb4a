"""The train step, on one device.

Counterpart of bifold_tpu/parallel/__init__.py:330-432 (``make_train_step``)
for a single device; the data/FSDP/tensor/pipeline modes are not ported.

``step(state, batch) -> (state, metrics)``: the model runs in ``train()``
mode on the processed batch with a dropout generator made fresh for this
step from the state's key generator (JAX splits a fresh dropout key per step
the same way), the loss is differentiated with respect to the trainable
parameters only (the optimizer's, ``requires_grad``; frozen towers get no
gradient and no dW work), and the optimizer updates them in place. Metrics
are device tensors, read by the caller when it needs them: ``loss``,
``grad_norm`` and ``grad_norm_trainable`` (the same value here: frozen
parameters carry no gradient), and the loss's per-head terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from bifold_tpu_torch.models.dropout import set_dropout_generator
from bifold_tpu_torch.optim import Optimizer

__all__ = ["TrainState", "make_train_step"]


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
                    optimizer: Optimizer) -> Callable:
    """The train step over ``optimizer.params`` (the trainable parameters)."""
    params = optimizer.params
    device = params[0].device

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=state.key))
        model.train()
        set_dropout_generator(model, torch.Generator(device).manual_seed(seed))
        try:
            out = model(batch)
            loss, inter = loss_fn(out, batch)
            grads = list(torch.autograd.grad(loss, params))
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
