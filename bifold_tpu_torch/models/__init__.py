"""Model construction, trainability and action decoding for the PyTorch port.

Counterpart of bifold_tpu/models/__init__.py:67-124 and :153-203 for the
four shipped model families (``siglip``, ``siglip_sequential``,
``rgb_clip``, ``text_unet``): :func:`build_model` takes the same config node
(keys are constructor fields, unknown keys are an error) and builds the
module on a device with a seeded init; :func:`trainable_mask` freezes the
backbone towers (``siglip_model``, ``clip_encoder``, ``text_encoder``) but
their LoRA adapters (via ``requires_grad``); :func:`precast_frozen` casts
big frozen weights to the compute dtype once; :func:`decode_action` turns
the heatmap dict into pixel arrays with mask snapping and bimanual gating,
at the family's ``threshold``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from bifold_tpu_torch.models.backbones.clip_backbone import (ClipBackbone,
                                                            ClipVisionTower)
from bifold_tpu_torch.models.backbones.t5_backbone import T5Encoder
from bifold_tpu_torch.models.bifold_models import (RGBOnly, SigLip,
                                                   SiglipSequential,
                                                   TextConditionedUNet)
from bifold_tpu_torch.models.fusion import (ConcatTransformer,
                                            MultiHeadDotProductAttention)
from bifold_tpu_torch.models.layers import (LayerNorm, MoEFeedForward,
                                            _ClipAttention)
from bifold_tpu_torch.models.lora import LoRALinear
from bifold_tpu_torch.models.norm import BatchNorm
from bifold_tpu_torch.ops.heatmap import decode_heatmap, gate_bimanual

__all__ = ["build_model", "init_weights", "decode_action", "resolve_device",
           "trainable_mask", "precast_frozen", "MODELS"]

MODELS = {"siglip": SigLip, "siglip_sequential": SiglipSequential,
          "rgb_clip": RGBOnly, "text_unet": TextConditionedUNet}

# the constructor fields of each family (those of its JAX dataclass)
_SIGLIP_FIELDS = {"image_size", "is_bimanual", "patch_size", "automodel_name",
                  "dim", "lora", "r", "lora_alpha", "depth", "heads",
                  "mlp_ratio", "threshold", "constrain_pick_mask",
                  "legacy_query_mask", "lora_dropout", "dropout", "emb_dropout",
                  "pick_place_model", "fusion_model", "moe_experts",
                  "moe_top_k", "moe_capacity_factor", "moe_aux_weight", "remat"}
_FIELDS = {
    "siglip": _SIGLIP_FIELDS,
    "siglip_sequential": _SIGLIP_FIELDS | {"context_length"},
    "rgb_clip": {"image_size", "is_bimanual", "patch_size", "text_encoder",
                 "text_dropout", "rgb_dropout", "threshold", "pick_place_model",
                 "fusion_model", "depth", "heads", "mlp_ratio", "dropout",
                 "constrain_pick_mask", "legacy_query_mask", "remat"},
    "text_unet": {"image_size", "is_bimanual", "text_encoder", "features",
                  "threshold", "constrain_pick_mask"},
}
# config keys of the JAX model the port runs at one value only (None: any
# value is accepted and has no effect here). ``requires_graph`` asks the
# Processor for graph features (its config node reads it); the forward
# ignores it, as JAX's modules do.
_SIGLIP_FIXED = {"requires_graph": None, "target_modules": ("q_proj", "v_proj"),
                 "text_encoder": None}
_FIXED = {"siglip": _SIGLIP_FIXED, "siglip_sequential": _SIGLIP_FIXED,
          "rgb_clip": {"requires_graph": None}, "text_unet": {"requires_graph": None}}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when the card is asked for and
    none is present (entry points never carry on silently on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    return device


def _lecun_normal(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's distributions: lecun-normal
    (truncated) dense, conv and transposed-conv kernels (CLIP's fused
    in-projection as its three q/k/v Dense kernels), zero biases, N(0, 0.02)
    embedding tables, unit LayerNorm and BatchNorm (running mean 0, variance
    1), peft's LoRA init (A uniform +-1/sqrt(fan_in), B zero), N(0, 1)
    learned tokens, registers and position embeddings of the heads,
    N(0, 0.02) MoE router and expert weights (zero expert biases),
    lecun-normal cross-attention kernels (fan in D for query/key/value,
    H x Dh for out), and CLIP's own:
    ``class_embedding``, the vision ``positional_embedding`` and
    ``text_projection`` N(0, width^-0.5), the text positions N(0, 0.01);
    T5's token and relative-position tables N(0, 1) (its RMS norms stay
    at 1)."""
    adapters = set()
    for mod in model.modules():
        if isinstance(mod, LoRALinear):
            for lin in mod.lora_A.values():
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)
            for lin in mod.lora_B.values():
                lin.weight.zero_()
            adapters.update(map(id, (*mod.lora_A.values(), *mod.lora_B.values())))
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) \
                and id(mod) not in adapters:
            # flax's fan in: kernel taps x input features (a transposed
            # conv's input features lead torch's weight)
            fan_in = (mod.weight[:, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0].numel())
            _lecun_normal(mod.weight, fan_in, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _ClipAttention):
            _lecun_normal(mod.in_proj_weight, mod.in_proj_weight.shape[1], generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, ClipVisionTower):
            std = mod.class_embedding.shape[0] ** -0.5
            mod.class_embedding.normal_(0.0, std, generator=generator)
            mod.positional_embedding.normal_(0.0, std, generator=generator)
        elif isinstance(mod, ClipBackbone):
            mod.positional_embedding.normal_(0.0, 0.01, generator=generator)
            mod.text_projection.normal_(0.0, mod.text_projection.shape[0] ** -0.5,
                                        generator=generator)
        elif isinstance(mod, MoEFeedForward):
            for w in (mod.router, mod.w1, mod.w2):
                w.normal_(0.0, 0.02, generator=generator)
            mod.b1.zero_()
            mod.b2.zero_()
        elif isinstance(mod, MultiHeadDotProductAttention):
            for dense in (mod.query, mod.key, mod.value):
                _lecun_normal(dense.kernel, dense.kernel.shape[0], generator)
                dense.bias.zero_()
            _lecun_normal(mod.out.kernel, mod.out.kernel[:, :, 0].numel(), generator)
            mod.out.bias.zero_()
        elif isinstance(mod, ConcatTransformer) and mod.num_registers:
            mod.registers.normal_(0.0, 1.0, generator=generator)
    for name in ("image_token", "text_token", "context_pos_embedding",
                 "rgb_pos_embedding", "text_pos_embedding"):
        p = getattr(model, name, None)
        if p is not None:
            p.normal_(0.0, 1.0, generator=generator)
    for mod in model.modules():
        if isinstance(mod, T5Encoder):
            mod.shared.weight.normal_(0.0, 1.0, generator=generator)
            attention = mod.encoder.block[0].layer[0].SelfAttention
            attention.relative_attention_bias.weight.normal_(0.0, 1.0, generator=generator)


_FROZEN_SUBTREES = ("siglip_model", "clip_encoder", "text_encoder")
_ALWAYS_TRAINABLE = ("lora_A", "lora_B")


def trainable_mask(model: nn.Module, *, lora: bool = True) -> Dict[str, bool]:
    """Set ``requires_grad`` as the reference trains: parameters under a
    backbone tower (``siglip_model``, ``clip_encoder``, ``text_encoder``)
    are frozen, except the LoRA adapters' ``lora_A`` / ``lora_B`` when
    ``lora``; everything else trains. Returns ``{parameter name:
    trainable}``."""
    mask = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        frozen = any(k in _FROZEN_SUBTREES for k in parts)
        adapter = any(k in _ALWAYS_TRAINABLE for k in parts)
        mask[name] = (lora and adapter) or not frozen
        p.requires_grad_(mask[name])
    return mask


@torch.no_grad()
def precast_frozen(model: nn.Module, compute_dtype, *,
                   min_size: int = 2 ** 16) -> List[str]:
    """Cast, in place, every frozen (``requires_grad=False``) float32
    parameter with at least ``min_size`` elements to ``compute_dtype``, once:
    the layers cast weights to the compute dtype at use, so this is
    value-identical and saves the per-step casts. Trainable parameters keep
    their float32 masters, small ones (LayerNorm, biases) stay float32. A
    no-op for a float32 (or None) compute dtype. Returns the names cast."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return []
    cast = []
    for name, p in model.named_parameters():
        if (not p.requires_grad and p.dtype == torch.float32
                and p.numel() >= min_size):
            p.data = p.data.to(compute_dtype)
            cast.append(name)
    return cast


def build_model(cfg: dict, *, dtype=torch.float32, device="cuda",
                seed: int | None = 0, remat: bool | None = None) -> nn.Module:
    """Model from its config node (``name`` + constructor fields), built on
    ``device`` with a seeded init (``seed=None``: torch's own init, for
    uses that need the shapes alone, such as the advisor's tensors without
    data), in eval mode; ``model.config`` keeps the
    node (a serving artifact records it). ``remat`` (the Trainer's
    ``precision.remat``) overrides the node's for the families that have
    it and is dropped for the others, as the JAX package's overrides are.
    LoRA ``target_modules`` other than q and v, which no JAX module reads,
    raise."""
    node = dict(cfg)
    cfg = {k: (tuple(v) if isinstance(v, list) else v) for k, v in node.items()}
    if remat is not None and "remat" in _FIELDS.get(cfg.get("name"), ()):
        cfg["remat"] = bool(remat)
    name = cfg.pop("name")
    if name not in MODELS:
        raise KeyError(f"model {name!r} is not ported (have {sorted(MODELS)})")
    fields, fixed = _FIELDS[name], _FIXED[name]
    unknown = set(cfg) - fields - set(fixed)
    if unknown:
        raise TypeError(f"{name} got unknown config keys: {sorted(unknown)}")
    for key, want in fixed.items():
        if want is not None and key in cfg and cfg[key] != want:
            raise NotImplementedError(f"{key}={cfg[key]!r} is not ported "
                                      f"(the port runs {want!r})")
    device = resolve_device(device)
    with torch.device(device):
        model = MODELS[name](**{k: v for k, v in cfg.items() if k in fields},
                             dtype=dtype)
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    model.config = node
    return model.eval()


def decode_action(output: dict, sample: dict, *, is_bimanual: bool,
                  constrain_pick_mask: bool = True, threshold: float = 0.5):
    """Heatmap dict -> dict of float32 (B, 2) ``[x, y]`` pixel tensors:
    pick snapped to the cloth mask (when present and enabled), place
    unconstrained, bimanual confidence gating (at least one arm acts). A
    2-d (B, nodes) pick map with the sample's ``pixel_sampled_pc`` (B,
    nodes, 2) is a graph model's: the pick is the pixel of its argmax node
    and the confidence that node's value (bifold_tpu/models/__init__.py
    :100-108)."""
    mask = sample.get("mask") if constrain_pick_mask else None
    use_mask = mask is not None
    if use_mask:
        mask = mask.reshape(mask.shape[0], mask.shape[-2], mask.shape[-1])

    def pick(hm):
        if hm.dim() == 2 and "pixel_sampled_pc" in sample:
            conf, idx = hm.max(dim=1)
            pc = sample["pixel_sampled_pc"]
            pix = pc.gather(1, idx[:, None, None].expand(-1, 1, 2))[:, 0]
            return pix.float(), conf
        return decode_heatmap(hm, mask, use_mask=use_mask)

    if is_bimanual:
        lp, lc = pick(output["left_pick_heatmap"])
        rp, rc = pick(output["right_pick_heatmap"])
        lpl, _ = decode_heatmap(output["left_place_heatmap"])
        rpl, _ = decode_heatmap(output["right_place_heatmap"])
        lp, rp, lpl, rpl = gate_bimanual(lp, rp, lpl, rpl, lc, rc, threshold)
        return {"left_pick": lp, "right_pick": rp, "left_place": lpl,
                "right_place": rpl, "left_confidence": lc,
                "right_confidence": rc}
    p, conf = pick(output["pick_heatmap"])
    place, _ = decode_heatmap(output["place_heatmap"])
    return {"pick": p.float(), "place": place.float(), "confidence": conf}
