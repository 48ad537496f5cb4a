"""LoRA adapter with peft's parameter names.

Counterpart of bifold_tpu/models/lora.py:32-50: out = base(x) +
((dropout(x) A) B) * alpha / r. Names match peft's ``LoraLayer`` so a
reference state dict loads as it is: ``base_layer``, ``lora_A.<adapter>``,
``lora_B.<adapter>`` (the reference's adapter is "siglip_adapter"). The
dropout on the adapter's input is active in ``train()`` mode only. Under a
column-parallel base (tensor parallelism) ``x A B`` is computed for the
rank's output rows only, so the gradients of A and B are partial there.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.models.dropout import Dropout

__all__ = ["LoRALinear", "ADAPTER", "LORA_TARGETS"]

ADAPTER = "siglip_adapter"
LORA_TARGETS = ("q_proj", "v_proj")  # the reference's target_modules


class LoRALinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float = 1.0, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.base_layer = nn.Linear(in_features, out_features)
        self.lora_dropout = Dropout(dropout)
        self.lora_A = nn.ModuleDict({ADAPTER: nn.Linear(in_features, rank, bias=False)})
        self.lora_B = nn.ModuleDict({ADAPTER: nn.Linear(rank, out_features, bias=False)})
        self.scaling = alpha / rank
        self.dtype = dtype

    def forward(self, x, tp=None):
        """``tp`` (a column-parallel base under tensor parallelism): the base
        holds this rank's output rows, and the replicated bias and ``B`` are
        cut to them."""
        dt = self.dtype
        x = x.to(dt)
        bias, b = self.base_layer.bias, self.lora_B[ADAPTER].weight
        if tp is not None:
            bias, b = tp.part(bias), tp.part(b)
        base = F.linear(x, self.base_layer.weight.to(dt), bias.to(dt))
        a = self.lora_A[ADAPTER].weight.to(dt)
        return base + F.linear(F.linear(self.lora_dropout(x), a), b.to(dt)) * self.scaling
