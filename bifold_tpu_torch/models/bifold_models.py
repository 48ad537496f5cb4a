"""The SigLIP model families: ``SigLip`` and ``SiglipSequential``.

Counterparts of bifold_tpu/models/bifold_models.py:49-205. Each consumes the
processor's sample dict and returns the heatmap dict
(``{left_,right_,}pick/place_{logits,heatmap}``). Towers and fusion run in
``dtype``; heads in float32. ``lora_dropout`` (tower adapters) and
``dropout`` (fusion stack) act in ``train()`` mode only; ``emb_dropout`` is
accepted and unused, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from bifold_tpu_torch.models.backbones import (
    SIGLIP_BASE_CONFIGS,
    SiglipBackbone,
    SiglipConfig,
)
from bifold_tpu_torch.models.pickplace import PickPlaceConvDecoder

__all__ = ["SigLip", "SiglipSequential"]


class SigLip(nn.Module):
    """SigLIP dual encoder + learned modality tokens + pick/place head."""

    def __init__(self, image_size: int, is_bimanual: bool, patch_size: int = 16,
                 automodel_name: str = "google/siglip-base-patch16-224",
                 dim: int = 768, lora: bool = True, r: int = 8,
                 lora_alpha: float = 32.0, depth: int = 8, heads: int = 16,
                 mlp_ratio: int = 4, threshold: float = 0.5,
                 constrain_pick_mask: bool = True,
                 legacy_query_mask: bool = False, lora_dropout: float = 0.01,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.image_size = image_size
        self.is_bimanual = is_bimanual
        self.dim = dim
        self.threshold = threshold
        self.constrain_pick_mask = constrain_pick_mask
        self.dtype = dtype
        self.num_patches = (image_size // patch_size) ** 2
        base = SIGLIP_BASE_CONFIGS.get(automodel_name, SiglipConfig())
        cfg = SiglipConfig(image_size=image_size, patch_size=patch_size,
                           hidden_size=dim, layers=base.layers, heads=base.heads,
                           mlp_dim=base.mlp_dim, vocab_size=base.vocab_size,
                           max_text_len=base.max_text_len)
        self.siglip_model = SiglipBackbone(cfg, r if lora else 0, lora_alpha,
                                           dtype, lora_dropout=lora_dropout)
        self.image_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.text_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pick_place = PickPlaceConvDecoder(
            dim, is_bimanual, self.num_patches, heads, depth, mlp_ratio,
            legacy_query_mask, dropout, dtype)

    def _with_token(self, feats, token):
        b = feats.shape[0]
        return torch.cat([token.to(feats.dtype).expand(b, 1, self.dim), feats],
                         dim=1)

    def forward(self, sample):
        text = self.siglip_model.encode_text(sample["instruction"])
        image = self.siglip_model.encode_image(sample["rgb"])
        return self.pick_place(self._with_token(text, self.text_token),
                               self._with_token(image, self.image_token))


class SiglipSequential(SigLip):
    """SigLip + temporal context frames through the shared vision tower (one
    batched pass of B*(T+1) frames) with learned context position
    embeddings and the [text | context | current] key mask."""

    def __init__(self, *args, context_length: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.context_length = context_length
        self.context_pos_embedding = nn.Parameter(
            torch.zeros(1, context_length * (self.num_patches + 1), self.dim))

    def forward(self, sample):
        if "rgb_context" not in sample:
            raise KeyError("siglip_sequential needs context frames "
                           "(rgb_context / context_attention_mask)")
        rgb, ctx = sample["rgb"], sample["rgb_context"]
        b, t = ctx.shape[0], ctx.shape[1]
        frames = torch.cat([rgb[:, None], ctx], dim=1)
        feats = self.siglip_model.encode_image(
            frames.reshape(b * (t + 1), *ctx.shape[2:]))
        feats = feats.reshape(b, t + 1, feats.shape[1], self.dim)
        image = self._with_token(feats[:, 0], self.image_token)
        n = image.shape[1]
        text = self._with_token(
            self.siglip_model.encode_text(sample["instruction"]), self.text_token)
        ctx_feats = feats[:, 1:]
        token = self.image_token.to(ctx_feats.dtype).expand(b, t, 1, self.dim)
        ctx_feats = torch.cat([token, ctx_feats], dim=2)
        ctx_feats = ctx_feats.reshape(b, t * n, self.dim)
        ctx_feats = ctx_feats + self.context_pos_embedding[:, : t * n].to(ctx_feats.dtype)

        ctx_mask = sample["context_attention_mask"].to(torch.int32)   # (B, T)
        ones = torch.ones((b, text.shape[1]), dtype=torch.int32, device=rgb.device)
        attention_masks = torch.cat(
            [ones, ctx_mask.repeat_interleave(n, dim=1),
             torch.ones((b, n), dtype=torch.int32, device=rgb.device)], dim=1)
        return self.pick_place(text, ctx_feats, image, modalities=[0, 1, 1],
                               attention_masks=attention_masks)
