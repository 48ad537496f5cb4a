"""Heatmap decoder head: the conv-upsample pyramid in its collapsed form.

Counterpart of bifold_tpu/models/decoders.py:40-89. The reference pyramid
(5 pointwise convs interleaved with 4 bilinear x2 upsamples, no
nonlinearity) is linear in channels and in pixels, so all five convs run at
the patch-grid resolution and ONE composed n -> 16n bilinear matrix per
axis follows (the f64 product of the four x2 matrices). Parameters keep the
reference's ``decoder_net.{0,2,4,6,8}`` 1x1-conv layout.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.ops.image import resample_matrix

__all__ = ["ConvDecoder"]


@lru_cache(maxsize=16)
def _up16_matrix(n: int) -> np.ndarray:
    """Composed n -> 16n matrix: the product of four x2 bilinear resample
    matrices (f64 accumulate, f32 result)."""
    r = np.eye(n, dtype=np.float64)
    m = n
    for _ in range(4):
        r = resample_matrix(m, 2 * m, "bilinear", antialias=False).astype(np.float64) @ r
        m *= 2
    return r.astype(np.float32)


class ConvDecoder(nn.Module):
    """(B, h, w, C) -> (B, 16h, 16w, out), channels C -> C/2 -> C/2 -> C/4
    -> C/4 -> out, computed in ``dtype`` (float32 for the heads)."""

    def __init__(self, input_dim: int, output_dim: int = 1, dtype=torch.float32):
        super().__init__()
        c1, c2 = input_dim // 2, input_dim // 4
        chans = [input_dim, c1, c1, c2, c2, output_dim]
        mods = []
        for i in range(5):
            mods.append(nn.Conv2d(chans[i], chans[i + 1], 1))
            if i != 4:
                mods.append(nn.Upsample(scale_factor=2, mode="bilinear"))
        self.decoder_net = nn.Sequential(*mods)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        for conv in self.decoder_net[::2]:
            x = F.linear(x, conv.weight[:, :, 0, 0].to(dt), conv.bias.to(dt))
        rh = torch.from_numpy(_up16_matrix(x.shape[-3])).to(x.device, dt)
        rw = torch.from_numpy(_up16_matrix(x.shape[-2])).to(x.device, dt)
        x = torch.einsum("oh,...hwc->...owc", rh, x)
        return torch.einsum("ow,...hwc->...hoc", rw, x)
