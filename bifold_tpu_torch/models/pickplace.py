"""Pick/place heads: fusion -> per-head decoders -> sigmoid heatmaps.

Counterpart of bifold_tpu/models/pickplace.py:21-201. Heads compute in
float32 and emit ``<name>_logits`` and ``<name>_heatmap`` (B, H, W).

- :class:`PickPlaceConvDecoder` (``pick_place_convdecoder``): one fusion;
  the summary token the model prepends to the image tokens is dropped, the
  rest reshaped to the patch grid, and one conv decoder per head;
- :class:`PickPlaceTransDecoder` (``pick_place_transdecoder``): a pick and
  a place fusion, one MAE transformer decoder each (float32, 2 output
  channels when bimanual), ``unpatchify``. Options: ``compute_mask`` (a
  third decoder on the image tokens whose sigmoid gates the pick heatmaps,
  which then carry no logits; ``detach_mask`` stops its gradient through
  the gate) and ``condition_place_on_pick`` (a float32 fusion at width
  patch^2 x channels over [pick | place] decoder tokens replaces the place
  tokens).

The fusion is named by ``fusion_model`` (:data:`FUSIONS`) and takes the
options of ``fusion_kwargs`` its constructor has. ``forward(...,
aux=list)`` appends the fusions' MoE load-balance losses to the list.
"""

from __future__ import annotations

import torch
from torch import nn

from bifold_tpu_torch.models.decoders import (ConvDecoder, TransformerDecoder,
                                              unpatchify)
from bifold_tpu_torch.models.fusion import FUSIONS, build_fusion

__all__ = ["PickPlaceConvDecoder", "PickPlaceTransDecoder", "PICK_PLACE",
           "FUSIONS", "head_names"]


def head_names(is_bimanual: bool):
    return (("left_pick", "right_pick", "left_place", "right_place")
            if is_bimanual else ("pick", "place"))


class PickPlaceConvDecoder(nn.Module):
    def __init__(self, dim: int, is_bimanual: bool, num_patches: int,
                 patch_size: int = 16, fusion_model: str = "concat_transformer",
                 fusion_kwargs: dict | None = None, dtype=torch.float32):
        super().__init__()
        self.fusion = build_fusion(fusion_model, dim, dict(fusion_kwargs or {}), dtype)
        self.names = head_names(is_bimanual)
        for n in self.names:
            setattr(self, f"{n}_decoder", ConvDecoder(dim, 1, torch.float32))
        self.sqrt_p = int(num_patches ** 0.5)

    def forward(self, *inputs, modalities=None, attention_masks=None, aux=None):
        fused = self.fusion(*inputs, modalities=modalities,
                            attention_masks=attention_masks, aux=aux)
        t = fused[:, 1:, :].float()
        grid = t.reshape(t.shape[0], self.sqrt_p, self.sqrt_p, t.shape[-1])
        out = {"attn_weights": None}
        for n in self.names:
            logits = getattr(self, f"{n}_decoder")(grid)[..., 0].float()
            out[f"{n}_logits"] = logits
            out[f"{n}_heatmap"] = torch.sigmoid(logits)
        return out


class PickPlaceTransDecoder(nn.Module):
    def __init__(self, dim: int, is_bimanual: bool, num_patches: int,
                 patch_size: int = 16, fusion_model: str = "concat_transformer",
                 fusion_kwargs: dict | None = None, decoder_embed_dim: int = 512,
                 decoder_num_heads: int = 16, decoder_mlp_ratio: int = 4,
                 decoder_depth: int = 2, compute_mask: bool = False,
                 detach_mask: bool = False, condition_place_on_pick: bool = False,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(fusion_kwargs or {})
        self.is_bimanual = is_bimanual
        self.num_patches = num_patches
        self.patch_size = patch_size
        self.out_channels = 2 if is_bimanual else 1
        self.detach_mask = detach_mask
        self.pick_fusion = build_fusion(fusion_model, dim, kw, dtype)
        self.place_fusion = build_fusion(fusion_model, dim, kw, dtype)

        def decoder(out_channels):
            return TransformerDecoder(dim, decoder_embed_dim, patch_size,
                                      num_patches, decoder_num_heads,
                                      decoder_mlp_ratio, decoder_depth,
                                      out_channels, torch.float32)

        self.mask_head = decoder(1) if compute_mask else None
        self.pick_decoder = decoder(self.out_channels)
        self.place_decoder = decoder(self.out_channels)
        self.pick_place_fusion = (
            build_fusion(fusion_model, patch_size ** 2 * self.out_channels, kw,
                         torch.float32) if condition_place_on_pick else None)

    def forward(self, *inputs, modalities=None, attention_masks=None, aux=None):
        def fuse(fusion):
            return fusion(*inputs, modalities=modalities,
                          attention_masks=attention_masks, aux=aux)

        out = {"pick_attn_weights": None, "place_attn_weights": None}
        fused_pick, fused_place = fuse(self.pick_fusion), fuse(self.place_fusion)
        p, c = self.patch_size, self.out_channels
        mask_hm = None
        if self.mask_head is not None:
            m = self.mask_head(inputs[-1][:, : self.num_patches + 1].float())
            mask_hm = torch.sigmoid(unpatchify(m, p, 1)[:, 0])
            out["mask_heatmap"] = mask_hm
            if self.detach_mask:
                mask_hm = mask_hm.detach()
        pick = self.pick_decoder(fused_pick.float())
        place = self.place_decoder(fused_place.float())
        if self.pick_place_fusion is not None:
            place = self.pick_place_fusion(pick, place, aux=aux)
            out["pick_place_attn_weights"] = None
        pick, place = unpatchify(pick, p, c), unpatchify(place, p, c)
        pairs = (("left_", 0), ("right_", 1)) if self.is_bimanual else (("", 0),)
        for prefix, idx in pairs:
            pick_hm = torch.sigmoid(pick[:, idx])
            if mask_hm is not None:
                pick_hm = mask_hm * pick_hm
            else:
                out[f"{prefix}pick_logits"] = pick[:, idx]
            out[f"{prefix}pick_heatmap"] = pick_hm
            out[f"{prefix}place_heatmap"] = torch.sigmoid(place[:, idx])
            out[f"{prefix}place_logits"] = place[:, idx]
        return out


PICK_PLACE = {"pick_place_convdecoder": PickPlaceConvDecoder,
              "pick_place_transdecoder": PickPlaceTransDecoder}
