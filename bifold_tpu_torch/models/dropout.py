"""Dropout with flax semantics and an explicit generator.

Counterpart of flax ``nn.Dropout`` as the JAX package uses it (LoRA input,
attention output, FFN, fusion): in ``train()`` mode with rate p > 0, each
element is kept with probability 1 - p and scaled by 1 / (1 - p), else set
to 0; in ``eval()`` mode it is the identity. The keep mask is drawn from
the module's ``generator`` — a ``torch.Generator`` on the activations'
device that the train step hands to every dropout module of the model for
one step (:func:`set_dropout_generator`) — never from torch's global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout", "set_dropout_generator"]


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} is outside [0, 1]")
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("dropout in train() mode needs a generator: "
                               "call set_dropout_generator(model, gen) first")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every :class:`Dropout` of ``model`` (None
    detaches them); the modules draw from it in call order."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
