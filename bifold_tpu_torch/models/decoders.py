"""Heatmap decoder heads: the conv-upsample pyramid and the MAE decoder.

Counterpart of bifold_tpu/models/decoders.py:40-134. The reference pyramid
(5 pointwise convs interleaved with 4 bilinear x2 upsamples, no
nonlinearity) is linear in channels and in pixels, so all five convs run at
the patch-grid resolution and ONE composed n -> 16n bilinear matrix per
axis follows (the f64 product of the four x2 matrices). Parameters keep the
reference's ``decoder_net.{0,2,4,6,8}`` 1x1-conv layout.

:class:`TransformerDecoder` is the MAE-style head of the transformer
decoder: ``decoder_embed``, a frozen 2-D sin-cos position embedding with a
cls slot (a buffer, not a parameter), pre-norm blocks with separate biased
q/k/v and exact GELU (``blocks.layers.<i>``, LayerNorm eps 1e-6),
``decoder_norm`` (flax's ``nn.LayerNorm``, which never takes the LayerNorm
kernels: the plain forward, differentiated by autograd as JAX
differentiates flax's) and ``decoder_pred`` to patch^2 x channels per token; the cls
token is dropped. :func:`unpatchify` folds the tokens back into an image.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.models.layers import (Transformer, gelu_exact,
                                            get_2d_sincos_pos_embed, linear)
from bifold_tpu_torch.ops.image import resample_matrix
from bifold_tpu_torch.ops.layer_norm import ln_forward_plain

__all__ = ["ConvDecoder", "TransformerDecoder", "upsample2x", "unpatchify"]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample of (..., H, W, C), torch ``Upsample(scale=2,
    align_corners=False)`` semantics, as two small matmuls."""
    h, w = x.shape[-3], x.shape[-2]
    rh = torch.from_numpy(resample_matrix(h, 2 * h, "bilinear", antialias=False))
    rw = torch.from_numpy(resample_matrix(w, 2 * w, "bilinear", antialias=False))
    x = torch.einsum("oh,...hwc->...owc", rh.to(x.device, x.dtype), x)
    return torch.einsum("ow,...hwc->...hoc", rw.to(x.device, x.dtype), x)


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


class TransformerDecoder(nn.Module):
    """(B, 1 + P, dim) tokens -> (B, P, patch^2 * out_channels), computed
    in ``dtype`` (float32 for the heads; see the module doc)."""

    def __init__(self, dim: int, decoder_embed_dim: int, patch_size: int,
                 num_patches: int, decoder_num_heads: int,
                 decoder_mlp_ratio: int, decoder_depth: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        e = decoder_embed_dim
        self.decoder_embed = nn.Linear(dim, e)
        pos = get_2d_sincos_pos_embed(e, int(num_patches ** 0.5), cls_token=True)
        self.register_buffer("pos_embed", torch.tensor(
            pos, device=self.decoder_embed.weight.device), persistent=False)
        self.blocks = Transformer(e, decoder_depth, decoder_num_heads,
                                  e * decoder_mlp_ratio, fused_qkv=False,
                                  ln_eps=1e-6, dtype=dtype, activation=gelu_exact)
        self.decoder_norm = nn.LayerNorm(e, eps=1e-6)     # parameters only
        self.decoder_pred = nn.Linear(e, patch_size ** 2 * out_channels)
        self.dtype = dtype

    def forward(self, x):
        x = linear(x, self.decoder_embed, self.dtype)
        x = x + self.pos_embed.to(x.dtype)[None]
        norm = self.decoder_norm
        x = ln_forward_plain(self.blocks(x), norm.weight, norm.bias, norm.eps)[0]
        return linear(x, self.decoder_pred, self.dtype)[:, 1:, :]


def unpatchify(x: torch.Tensor, patch_size: int, out_channels: int) -> torch.Tensor:
    """(B, h*w, p*p*c) -> (B, c, h*p, w*p)."""
    b, n, _ = x.shape
    hw = int(n ** 0.5)
    x = x.reshape(b, hw, hw, patch_size, patch_size, out_channels)
    x = x.permute(0, 5, 1, 3, 2, 4)                     # b c h p1 w p2
    return x.reshape(b, out_channels, hw * patch_size, hw * patch_size)
