"""Pick/place head: fusion -> per-head conv decoders -> sigmoid heatmaps.

Counterpart of bifold_tpu/models/pickplace.py:32-106 (no mask head: the
SigLIP families never configure one). The summary token the model prepends
to the image tokens is dropped, the rest reshaped to the patch grid, and
each head emits ``<name>_logits`` and ``<name>_heatmap`` in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from bifold_tpu_torch.models.decoders import ConvDecoder
from bifold_tpu_torch.models.fusion import ConcatTransformer

__all__ = ["PickPlaceConvDecoder", "head_names"]


def head_names(is_bimanual: bool):
    return (("left_pick", "right_pick", "left_place", "right_place")
            if is_bimanual else ("pick", "place"))


class PickPlaceConvDecoder(nn.Module):
    def __init__(self, dim: int, is_bimanual: bool, num_patches: int,
                 heads: int, depth: int, mlp_ratio: int = 4,
                 legacy_query_mask: bool = False, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.fusion = ConcatTransformer(dim, heads, depth, mlp_ratio,
                                        legacy_query_mask=legacy_query_mask,
                                        dropout=dropout, dtype=dtype)
        self.names = head_names(is_bimanual)
        for n in self.names:
            setattr(self, f"{n}_decoder", ConvDecoder(dim, 1, torch.float32))
        self.sqrt_p = int(num_patches ** 0.5)

    def forward(self, *inputs, modalities=None, attention_masks=None):
        fused = self.fusion(*inputs, modalities=modalities,
                            attention_masks=attention_masks)
        t = fused[:, 1:, :].float()
        grid = t.reshape(t.shape[0], self.sqrt_p, self.sqrt_p, t.shape[-1])
        out = {"attn_weights": None}
        for n in self.names:
            logits = getattr(self, f"{n}_decoder")(grid)[..., 0].float()
            out[f"{n}_logits"] = logits
            out[f"{n}_heatmap"] = torch.sigmoid(logits)
        return out
