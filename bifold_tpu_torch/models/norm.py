"""BatchNorm with flax's semantics, for the UNet family.

Counterpart of ``flax.linen.BatchNorm`` as bifold_tpu/models/bifold_models.py
:282-379 uses it (momentum 0.99, epsilon 1e-5, ``use_running_average``
in eval), over the channels of an NCHW tensor (any memory format):

- statistics in float32 whatever the input type: mean = E[x] and the
  *biased* variance var = max(0, E[x^2] - E[x]^2), over batch and pixels;
- in ``train()`` mode the batch statistics normalize and the running ones
  move, ``running = 0.99 * running + 0.01 * batch`` (the batch variance
  biased, as flax keeps it). ``torch.nn.BatchNorm2d`` would give the batch
  a weight of 0.1 and store the unbiased variance, and so drift from the
  JAX model from the first step;
- in ``eval()`` mode the running statistics normalize;
- ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
  cast to ``dtype``.

Gradients flow through the batch statistics, as JAX differentiates them.

Under a ``torch.distributed`` group of more than one rank (data
parallelism, each rank a contiguous, equal slice of the global batch) the
train-mode statistics are the global batch's, as JAX's are over a sharded
batch: each rank's E[x] and E[x^2], times its share of the batch, are
summed over the ranks by a differentiable all-reduce (its backward sums the
statistics' gradients over the ranks), so the normalization and the
running statistics equal a one-process run's. Under a mesh the statistics
are summed over the data ranks only (``group``, which a placement sets:
the ranks of a tp group hold the same rows).
The buffers are ``running_mean`` and ``running_var`` (the reference's
names, JAX's ``batch_stats`` ``mean`` / ``var``); there is no
``num_batches_tracked``. The running update is in place under
``torch.no_grad`` and happens on every train-mode forward, whatever the
optimizer then does with the step (JAX merges the mutated statistics into
its state unconditionally).
"""

from __future__ import annotations

import torch
from torch import nn

from bifold_tpu_torch.parallel.collectives import all_reduce_sum, group_size

__all__ = ["BatchNorm"]


class BatchNorm(nn.Module):
    group = None      # the data ranks' group; None: the default group

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, meansq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            world = group_size(self.group)
            if world > 1:
                mean, meansq = all_reduce_sum(torch.stack([mean, meansq]) / world,
                                              self.group)
            var = (meansq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias.float()[:, None, None]
        return y.to(self.dtype)
