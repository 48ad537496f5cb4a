"""The model families: ``SigLip``, ``SiglipSequential``, ``RGBOnly`` and
``TextConditionedUNet``.

Counterparts of bifold_tpu/models/bifold_models.py:49-379. Each consumes the
processor's sample dict and returns the heatmap dict
(``{left_,right_,}pick/place_{logits,heatmap}``). Towers and fusion run in
``dtype``; heads in float32. ``lora_dropout`` (tower adapters) and
``dropout`` (fusion stack) act in ``train()`` mode only; ``emb_dropout`` is
accepted and unused, as in the JAX model.

``RGBOnly`` (``rgb_clip``): the frozen CLIP towers' token features, the
image tokens projected to the text width, learned position embeddings and
the shared pick/place head at that width. ``TextConditionedUNet``
(``text_unet``): a depth UNet whose decoder blocks are FiLM-modulated by a
frozen text encoder's pooled features (CLIP's EOT token, or T5's first
token; no gradient reaches the encoder), with flax-semantics BatchNorm
(:mod:`bifold_tpu_torch.models.norm`) and per-pixel heads in float32. Its convolutions run in channels-last
memory; weights keep the reference's shapes (Conv2d (out, in, kh, kw),
ConvTranspose2d (in, out, kh, kw) with torch's tap order, which
``convert_text_unet_inverse`` gives).
"""

from __future__ import annotations

import torch
from torch import nn

import dataclasses

from torch.nn import functional as F

from bifold_tpu_torch.models.backbones import (
    CLIP_CONFIGS,
    CLIP_TEXT_CONFIGS,
    SIGLIP_BASE_CONFIGS,
    ClipBackbone,
    SiglipBackbone,
    SiglipConfig,
)
from bifold_tpu_torch.models.backbones.t5_backbone import T5Encoder, resolve_t5_config
from bifold_tpu_torch.models.dropout import Dropout
from bifold_tpu_torch.models.layers import linear
from bifold_tpu_torch.models.norm import BatchNorm
from bifold_tpu_torch.models.pickplace import PICK_PLACE, head_names

__all__ = ["SigLip", "SiglipSequential", "RGBOnly", "TextConditionedUNet"]


class SigLip(nn.Module):
    """SigLIP dual encoder + learned modality tokens + pick/place head.

    ``pick_place_model`` and ``fusion_model`` name the head and its fusion
    (bifold_tpu/models/bifold_models.py:34-46, :107-117); ``moe_experts`` >
    0 makes the concat fusion's FFNs Mixtures of Experts, and in ``train()``
    mode the output then carries ``moe_losses``, the (layers,) float32
    load-balance losses of every MoE layer, which the train step weighs in
    with ``moe_aux_weight`` (JAX sows them into ``moe_losses``). ``remat``
    recomputes every tower and fusion block in the backward."""

    def __init__(self, image_size: int, is_bimanual: bool, patch_size: int = 16,
                 automodel_name: str = "google/siglip-base-patch16-224",
                 dim: int = 768, lora: bool = True, r: int = 8,
                 lora_alpha: float = 32.0, depth: int = 8, heads: int = 16,
                 mlp_ratio: int = 4, threshold: float = 0.5,
                 constrain_pick_mask: bool = True,
                 legacy_query_mask: bool = False, lora_dropout: float = 0.01,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 pick_place_model: str = "pick_place_convdecoder",
                 fusion_model: str = "concat_transformer", moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if pick_place_model not in PICK_PLACE:
            raise ValueError(f"unknown pick_place_model {pick_place_model!r} "
                             f"(have {sorted(PICK_PLACE)})")
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
                                           dtype, lora_dropout=lora_dropout,
                                           remat=remat)
        self.image_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.text_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.moe_experts = moe_experts
        self.moe_aux_weight = moe_aux_weight
        fusion_kwargs = dict(heads=heads, depth=depth, dropout=dropout,
                             mlp_ratio=mlp_ratio, moe_experts=moe_experts,
                             moe_top_k=moe_top_k,
                             moe_capacity_factor=moe_capacity_factor,
                             legacy_query_mask=legacy_query_mask, remat=remat)
        self.pick_place = PICK_PLACE[pick_place_model](
            dim, is_bimanual, self.num_patches, patch_size, fusion_model,
            fusion_kwargs, dtype=dtype)

    def _with_token(self, feats, token):
        b = feats.shape[0]
        return torch.cat([token.to(feats.dtype).expand(b, 1, self.dim), feats],
                         dim=1)

    def _head(self, *inputs, **kwargs):
        """The pick/place head's output, with ``moe_losses`` in train mode
        when the fusion has MoE layers."""
        aux = []
        out = self.pick_place(*inputs, aux=aux, **kwargs)
        if aux and self.training:
            out["moe_losses"] = torch.stack([a.float() for a in aux])
        return out

    def forward(self, sample):
        text = self.siglip_model.encode_text(sample["instruction"])
        image = self.siglip_model.encode_image(sample["rgb"])
        return self._head(self._with_token(text, self.text_token),
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
        return self._head(text, ctx_feats, image, modalities=[0, 1, 1],
                          attention_masks=attention_masks)


class RGBOnly(nn.Module):
    """Frozen CLIP token encoders + projection + pick/place head (JAX
    bifold_models.py:208-279): image tokens (CLS + patches, after ln_post)
    projected to the text width plus ``rgb_pos_embedding``; text tokens
    after ln_final behind ``text_token``, plus ``text_pos_embedding``;
    both through their dropouts, then the head ``pick_place_model`` with
    its fusion ``fusion_model`` at the text width, as ``SigLip`` builds
    them (JAX's ``_pick_place``, bifold_models.py:34-46); the fusion blocks
    are recomputed in the backward under ``remat``, as JAX's
    bifold_models.py:277 has it, the CLIP towers never."""

    def __init__(self, image_size: int, is_bimanual: bool, patch_size: int = 16,
                 text_encoder: str = "ViT-B/16", text_dropout: float = 0.0,
                 rgb_dropout: float = 0.0, threshold: float = 0.5,
                 pick_place_model: str = "pick_place_convdecoder",
                 fusion_model: str = "concat_transformer",
                 depth: int = 8, heads: int = 16, mlp_ratio: int = 4,
                 dropout: float = 0.0, constrain_pick_mask: bool = True,
                 legacy_query_mask: bool = False, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if pick_place_model not in PICK_PLACE:
            raise ValueError(f"unknown pick_place_model {pick_place_model!r} "
                             f"(have {sorted(PICK_PLACE)})")
        if text_encoder not in CLIP_CONFIGS:
            raise ValueError(
                f"rgb_clip text_encoder={text_encoder!r} is not a ViT CLIP "
                f"model; supported: {sorted(CLIP_CONFIGS)} (the reference's "
                "RGBOnly reads visual.ln_post, which the ResNet towers lack)")
        self.image_size = image_size
        self.is_bimanual = is_bimanual
        self.threshold = threshold
        self.constrain_pick_mask = constrain_pick_mask
        self.dtype = dtype
        self.num_patches = (image_size // patch_size) ** 2
        cfg = dataclasses.replace(CLIP_CONFIGS[text_encoder], image_size=image_size)
        self.clip_encoder = ClipBackbone(cfg, dtype)
        dim = self.dim = cfg.text_width
        self.project = nn.Linear(cfg.vision_width, dim)
        self.rgb_pos_embedding = nn.Parameter(torch.zeros(1, self.num_patches + 1, dim))
        self.text_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.text_pos_embedding = nn.Parameter(
            torch.zeros(1, cfg.context_length + 1, dim))
        self.rgb_dropout = Dropout(rgb_dropout)
        self.text_dropout = Dropout(text_dropout)
        self.pick_place = PICK_PLACE[pick_place_model](
            dim, is_bimanual, self.num_patches, patch_size, fusion_model,
            dict(heads=heads, depth=depth, mlp_ratio=mlp_ratio,
                 legacy_query_mask=legacy_query_mask, dropout=dropout, remat=remat),
            dtype=dtype)

    def forward(self, sample):
        clip = self.clip_encoder
        x_rgb = linear(clip.encode_image_with_embeddings(sample["rgb"]),
                       self.project, self.dtype)
        x_rgb = self.rgb_dropout(x_rgb + self.rgb_pos_embedding.to(x_rgb.dtype))
        x_text = clip.encode_text_with_embeddings(sample["instruction"])
        b, n_txt, _ = x_text.shape
        x_text = torch.cat([self.text_token.to(x_text.dtype).expand(b, 1, self.dim),
                            x_text], dim=1)
        x_text = x_text + self.text_pos_embedding[:, : n_txt + 1].to(x_text.dtype)
        return self.pick_place(self.text_dropout(x_text), x_rgb)


class _FiLM(nn.Module):
    """The FiLM layer of a decoder block (reference names ``film.conv``,
    ``film.gamma``, ``film.beta``)."""

    def __init__(self, cond_dim: int, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.gamma = nn.Linear(cond_dim, channels)
        self.beta = nn.Linear(cond_dim, channels)


def _conv(x, conv: nn.Conv2d, dtype):
    """``conv(x)`` in ``dtype`` (flax ``nn.Conv(dtype=...)``)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias,
                    stride=conv.stride, padding=conv.padding)


class _FiLMBlock(nn.Module):
    """x2 transposed-conv upsample, [skip | upsampled] concat, conv-BN-ReLU,
    conv-BN, then the FiLM conv times (1 + gamma(cond)) plus beta(cond), ReLU
    (JAX bifold_models.py:282-310). gamma and beta are float32 Dense layers,
    so the block's output is float32, as in JAX."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int,
                 dtype=torch.float32):
        super().__init__()
        half = in_channels // 2
        self.convt = nn.ConvTranspose2d(in_channels, half, 2, stride=2)
        self.conv1 = nn.Conv2d(out_channels + half, out_channels, 3, padding=1)
        self.bn1 = BatchNorm(out_channels, dtype=dtype)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)
        self.film = _FiLM(cond_dim, out_channels)
        self.dtype = dtype

    def forward(self, x1, x2, cond):
        dt = self.dtype
        x1 = F.conv_transpose2d(x1.to(dt), self.convt.weight.to(dt),
                                self.convt.bias.to(dt), stride=2)
        x = torch.cat([x2.to(dt), x1], dim=1)
        x = torch.relu(self.bn1(_conv(x, self.conv1, dt)))
        x = self.bn2(_conv(x, self.conv2, dt))
        film = self.film
        gamma = F.linear(cond.float(), film.gamma.weight.float(), film.gamma.bias.float())
        beta = F.linear(cond.float(), film.beta.weight.float(), film.beta.bias.float())
        x = _conv(x, film.conv, dt).float() * (1 + gamma[:, :, None, None]) \
            + beta[:, :, None, None]
        return torch.relu(x)


class TextConditionedUNet(nn.Module):
    """Depth UNet with FiLM decoder blocks conditioned on a frozen text
    encoder (JAX bifold_models.py:312-379): a CLIP model name takes the
    CLIP text tower (``clip_encoder``, its EOT token's ln_final features),
    anything else goes through ``resolve_t5_config`` (a T5 registry name or
    a local T5 checkpoint dir, else ``ValueError``) to the T5 encoder
    (``text_encoder``, pooled at token 0 of its last hidden state, :347).
    ``encoder.<i>`` is [conv, BN, ReLU, conv, BN, ReLU] (bias-free convs)
    after a 2x2 max pool for i > 0; ``decoder.<j>`` are the FiLM blocks up
    the skips; one 1x1 head per action (``<name>_decoder``) gives
    ``<name>_logits`` and ``<name>_heatmap`` in float32 at the input
    resolution. The text condition is computed without gradient; T5's
    dropout acts in ``train()`` mode, as JAX's does."""

    def __init__(self, image_size: int, is_bimanual: bool,
                 text_encoder: str = "RN50",
                 features=(64, 128, 256, 512, 1024), threshold: float = 0.5,
                 constrain_pick_mask: bool = True, dtype=torch.float32):
        super().__init__()
        cfg = CLIP_CONFIGS.get(text_encoder) or CLIP_TEXT_CONFIGS.get(text_encoder)
        if cfg is not None:
            self.clip_encoder = ClipBackbone(cfg, dtype, vision=False)
            cond_dim = cfg.text_width
        else:
            self.text_encoder = T5Encoder(resolve_t5_config(text_encoder), dtype)
            cond_dim = self.text_encoder.cfg.d_model
        self.image_size = image_size
        self.is_bimanual = is_bimanual
        self.threshold = threshold
        self.constrain_pick_mask = constrain_pick_mask
        self.dtype = dtype
        feats = list(features)
        self.encoder = nn.ModuleList()
        for i, f in enumerate(feats):
            c_in = 1 if i == 0 else feats[i - 1]
            self.encoder.append(nn.Sequential(
                nn.Conv2d(c_in, f, 3, padding=1, bias=False), BatchNorm(f, dtype=dtype),
                nn.ReLU(), nn.Conv2d(f, f, 3, padding=1, bias=False),
                BatchNorm(f, dtype=dtype), nn.ReLU()))
        self.decoder = nn.ModuleList(
            _FiLMBlock(feats[i + 1], feats[i], cond_dim, dtype)
            for i in range(len(feats) - 2, -1, -1))
        self.names = head_names(is_bimanual)
        for name in self.names:
            setattr(self, f"{name}_decoder", nn.Conv2d(feats[0], 1, 1))

    def forward(self, sample):
        ids = sample["instruction"]
        with torch.no_grad():     # the reference encodes the text under no_grad
            if hasattr(self, "clip_encoder"):
                cond = self.clip_encoder.encode_text_with_embeddings(ids)
                cond = cond[torch.arange(ids.shape[0], device=ids.device),
                            ids.argmax(dim=-1)]
            else:
                cond = self.text_encoder(ids)[:, 0]
        x = sample["depth"].to(self.dtype).contiguous(memory_format=torch.channels_last)
        skips = []
        for i, block in enumerate(self.encoder):
            if i:
                x = F.max_pool2d(x, 2, 2)
            conv0, bn0, _, conv1, bn1, _ = block
            x = torch.relu(bn0(_conv(x, conv0, self.dtype)))
            x = torch.relu(bn1(_conv(x, conv1, self.dtype)))
            if i < len(self.encoder) - 1:
                skips.append(x)
        for block, skip in zip(self.decoder, reversed(skips)):
            x = block(x, skip, cond)
        x = x.float().permute(0, 2, 3, 1)                     # (B, H, W, C)
        out = {}
        for name in self.names:
            head = getattr(self, f"{name}_decoder")
            logits = F.linear(x, head.weight[:, :, 0, 0].float(), head.bias.float())[..., 0]
            out[f"{name}_logits"] = logits
            out[f"{name}_heatmap"] = torch.sigmoid(logits)
        return out
