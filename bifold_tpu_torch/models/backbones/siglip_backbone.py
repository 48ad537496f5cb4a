"""SigLIP dual encoder (vision ViT + text transformer) with HF names.

Counterpart of bifold_tpu/models/backbones/siglip_backbone.py:33-166:

- vision: 16x16 patch conv (no cls token), learned position embedding,
  pre-LN encoder with gelu-tanh MLPs, ``post_layernorm`` -> (B, P, D);
- text: token + position embeddings, the same encoder,
  ``final_layer_norm`` -> (B, L, D); no causal and no padding mask.

With LoRA the towers sit under ``model`` (peft's ``LoraModel`` wrapping), so
state-dict keys read ``siglip_model.model.vision_model...`` as in the
reference. ``remat`` recomputes each encoder block in the backward (JAX's
``remat``, bifold_tpu/models/backbones/siglip_backbone.py:58-81).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.models.layers import LayerNorm, Transformer

__all__ = ["SiglipConfig", "SIGLIP_BASE_CONFIGS", "SiglipBackbone"]


@dataclass(frozen=True)
class SiglipConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    vocab_size: int = 32000
    max_text_len: int = 64

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


SIGLIP_BASE_CONFIGS = {
    "google/siglip-base-patch16-224": SiglipConfig(image_size=224),
    "google/siglip-base-patch16-384": SiglipConfig(image_size=384),
    "tiny": SiglipConfig(layers=2, heads=4, mlp_dim=256),  # tests and smokes
}


def _encoder(cfg: SiglipConfig, lora_rank, lora_alpha, lora_dropout, dtype,
             remat):
    return Transformer(cfg.hidden_size, cfg.layers, cfg.heads, cfg.mlp_dim,
                       dim_head=cfg.hidden_size // cfg.heads, fused_qkv=False,
                       lora_rank=lora_rank, lora_alpha=lora_alpha,
                       lora_dropout=lora_dropout, ln_eps=1e-6, dtype=dtype,
                       remat=remat)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size)


class SiglipVisionTower(nn.Module):
    def __init__(self, cfg: SiglipConfig, lora_rank=0, lora_alpha=1.0,
                 lora_dropout=0.0, dtype=torch.float32, remat=False):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.encoder = _encoder(cfg, lora_rank, lora_alpha, lora_dropout, dtype,
                                remat)
        self.post_layernorm = LayerNorm(cfg.hidden_size, 1e-6, dtype)
        self.dtype = dtype

    def forward(self, pixel_values):
        """(B, 3, H, W) normalized floats -> (B, P, D) in ``dtype``."""
        dt = self.dtype
        conv = self.embeddings.patch_embedding
        x = F.conv2d(pixel_values.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)                      # (B, P, D)
        x = x + self.embeddings.position_embedding.weight[None].to(dt)
        return self.post_layernorm(self.encoder(x))


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_text_len, cfg.hidden_size)


class SiglipTextTower(nn.Module):
    def __init__(self, cfg: SiglipConfig, lora_rank=0, lora_alpha=1.0,
                 lora_dropout=0.0, dtype=torch.float32, remat=False):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _encoder(cfg, lora_rank, lora_alpha, lora_dropout, dtype,
                                remat)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-6, dtype)
        self.dtype = dtype

    def forward(self, input_ids):
        """(B, L) integer ids -> (B, L, D) in ``dtype``."""
        dt = self.dtype
        tok = self.embeddings.token_embedding.weight[input_ids.long()].to(dt)
        pos = self.embeddings.position_embedding.weight[: input_ids.shape[1]]
        x = tok + pos[None].to(dt)
        return self.final_layer_norm(self.encoder(x))


class SiglipBackbone(nn.Module):
    """Both towers, under ``model`` when LoRA wraps them (peft naming)."""

    def __init__(self, cfg: SiglipConfig, lora_rank=0, lora_alpha=1.0,
                 dtype=torch.float32, lora_dropout=0.0, remat=False):
        super().__init__()
        vision = SiglipVisionTower(cfg, lora_rank, lora_alpha, lora_dropout,
                                   dtype, remat)
        text = SiglipTextTower(cfg, lora_rank, lora_alpha, lora_dropout, dtype,
                               remat)
        holder = self
        if lora_rank > 0:
            self.model = nn.Module()
            holder = self.model
        holder.vision_model = vision
        holder.text_model = text

    def _towers(self):
        return self.model if hasattr(self, "model") else self

    def encode_image(self, pixel_values):
        return self._towers().vision_model(pixel_values)

    def encode_text(self, input_ids):
        return self._towers().text_model(input_ids)
