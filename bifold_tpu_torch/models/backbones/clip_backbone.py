"""CLIP dual encoder (ViT vision tower + causal text tower) of the port.

Counterpart of bifold_tpu/models/backbones/clip_backbone.py:52-203: the
same configurations (``ClipConfig``, ``CLIP_CONFIGS`` for the ViT models,
``CLIP_TEXT_CONFIGS`` for the text towers of the ResNet models), the same
token-level entry points, with OpenAI CLIP's parameter names so that the
reference's (and ``convert_bifold_inverse``'s) state dict loads with
``strict=True``:

- ``visual.conv1`` (bias-free patch conv), ``visual.class_embedding``,
  ``visual.positional_embedding``, ``visual.ln_pre``,
  ``visual.transformer.resblocks.<i>``, ``visual.ln_post``;
- ``token_embedding``, ``positional_embedding``,
  ``transformer.resblocks.<i>`` (causal), ``ln_final``, ``text_projection``
  (width, embed_dim), used as ``x @ text_projection``.

Entry points: :meth:`ClipBackbone.encode_image_with_embeddings` (ln_post
over all P + 1 tokens, no projection), :meth:`encode_text_with_embeddings`
(the ln_final token sequence) and :meth:`encode_text` (the token at the
largest id, EOT, times ``text_projection``). A backbone built with
``vision=False`` (the text-only ``CLIP_TEXT_CONFIGS`` names, whose ResNet
vision tower is not implemented) has no ``visual``. Everything computes in
``dtype`` with LayerNorm statistics and QuickGELU in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.models.layers import ClipTransformer, LayerNorm

__all__ = ["ClipConfig", "ClipBackbone", "ClipVisionTower", "CLIP_CONFIGS",
           "CLIP_TEXT_CONFIGS"]


@dataclass(frozen=True)
class ClipConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408
    embed_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_CONFIGS = {
    "ViT-B/16": ClipConfig(patch_size=16),
    "ViT-B/32": ClipConfig(patch_size=32),
    "ViT-L/14": ClipConfig(
        patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_heads=12, embed_dim=768),
    "ViT-L/14@336px": ClipConfig(
        image_size=336, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_heads=12, embed_dim=768),
}

# text towers of the ResNet CLIP models (only encode_text* is valid)
CLIP_TEXT_CONFIGS = {
    "RN50": ClipConfig(embed_dim=1024),
    "RN101": ClipConfig(embed_dim=512),
    "RN50x4": ClipConfig(text_width=640, text_heads=10, embed_dim=640),
    "RN50x16": ClipConfig(text_width=768, text_heads=12, embed_dim=768),
    "RN50x64": ClipConfig(text_width=1024, text_heads=16, embed_dim=1024),
}


class ClipVisionTower(nn.Module):
    """(B, 3, H, W) pixels -> (B, P + 1, vision_width) after ln_post."""

    def __init__(self, cfg: ClipConfig, dtype=torch.float32):
        super().__init__()
        width = cfg.vision_width
        self.patch_size = cfg.patch_size
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width, cfg.patch_size, stride=cfg.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, width))
        self.ln_pre = LayerNorm(width, 1e-5, dtype)
        self.transformer = ClipTransformer(width, cfg.vision_layers,
                                           cfg.vision_heads, dtype=dtype)
        self.ln_post = LayerNorm(width, 1e-5, dtype)

    def forward(self, pixel_values):
        x = F.conv2d(pixel_values.to(self.dtype), self.conv1.weight.to(self.dtype),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                  # (B, P, W), row-major
        b, _, width = x.shape
        cls = self.class_embedding.to(self.dtype).expand(b, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x)


class ClipBackbone(nn.Module):
    """The vision tower (``vision``) and the text tower of one CLIP model."""

    def __init__(self, cfg: ClipConfig, dtype=torch.float32, vision: bool = True):
        super().__init__()
        self.dtype = dtype
        if vision:
            self.visual = ClipVisionTower(cfg, dtype)
        width = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, width))
        self.transformer = ClipTransformer(width, cfg.text_layers,
                                           cfg.text_heads, causal=True,
                                           dtype=dtype)
        self.ln_final = LayerNorm(width, 1e-5, dtype)
        self.text_projection = nn.Parameter(torch.zeros(width, cfg.embed_dim))

    def encode_image_with_embeddings(self, pixel_values):
        return self.visual(pixel_values)

    def encode_text_with_embeddings(self, input_ids):
        """(B, N) int ids -> (B, N, text_width) after ln_final."""
        n = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.token_embedding.weight).to(self.dtype)
        x = x + self.positional_embedding[:n].to(self.dtype)
        return self.ln_final(self.transformer(x))

    def encode_text(self, input_ids):
        """The EOT token's features (EOT has the largest id) times
        ``text_projection``: (B, embed_dim)."""
        x = self.encode_text_with_embeddings(input_ids)
        eot = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)
