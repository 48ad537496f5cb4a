"""Test-partition preprocessing: raw records -> model-ready samples, on device.

Counterpart of bifold_tpu/data/processor.py:62-230 and :233-360 for the
partition serving and evaluation use (no augmentation, no gaussmap
targets). The host builds a fixed-schema raw record (:meth:`Processor.make_raw`:
uint8 rgb, float depth and mask, tokenized instruction, context frames padded
to ``max_context_length``); :func:`_core` then runs the image transforms as
tensor operations on the device the inputs live on: gray-77 composite with
uint8 truncation, PIL-exact bicubic resize as two matrix products, SigLIP or
CLIP normalize, masked depth, rounded mask, context padding and mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from bifold_tpu_torch.data.tokenizers import build_tokenizer
from bifold_tpu_torch.ops import depth as depth_ops
from bifold_tpu_torch.ops import image as image_ops

__all__ = ["Processor", "MAX_LABEL_POINTS"]

MAX_LABEL_POINTS = 8
_DUMMY = -np.ones((MAX_LABEL_POINTS, 2), dtype=np.float32)


def pad_label(val: Optional[np.ndarray]) -> np.ndarray:
    """(2,) or (k, 2) label -> fixed (8, 2) float32 padded with -1."""
    out = _DUMMY.copy()
    if val is not None:
        val = np.asarray(val, np.float32).reshape(-1, 2)[:MAX_LABEL_POINTS]
        out[: len(val)] = val
    return out


@dataclasses.dataclass(frozen=True)
class _CoreSpec:
    """Static configuration of one :func:`_core` call."""

    image_size: int
    mask_depth: bool
    image_mean: tuple
    image_std: tuple
    siglip_norm: bool
    label_keys: tuple
    has_rgb: bool
    has_depth: bool
    has_mask: bool
    n_context: int
    context_rgb: bool


def _resize(x, size):
    return image_ops.resize(x, size, method="bicubic", antialias=True)


def _process_rgb(spec: _CoreSpec, rgb_u8, mask):
    """uint8 (B, H, W, 3) + optional (B, H, W) mask -> normalized (B, 3, S, S)."""
    rgb = rgb_u8.permute(0, 3, 1, 2)
    if mask is not None:
        rgb = image_ops.composite_background(rgb, mask)
    resized = _resize(rgb.float(), spec.image_size)
    mean = image_ops.SIGLIP_MEAN if spec.siglip_norm else spec.image_mean
    std = image_ops.SIGLIP_STD if spec.siglip_norm else spec.image_std
    return image_ops.normalize(resized, mean, std)


def _process_depth(spec: _CoreSpec, depth, mask):
    """(B, H, W) depth (+mask) -> (B, 1, S, S): mask-multiply, resize."""
    depth = depth.float()
    if spec.mask_depth and mask is not None:
        depth = depth_ops.mask_depth(depth, mask)
    return _resize(depth, spec.image_size)[:, None]


def _core(spec: _CoreSpec, rgb, depth, mask, ctx_rgb, ctx_depth, ctx_mask,
          ctx_count, labels) -> Dict[str, Any]:
    """The test-partition pipeline on device tensors at the input
    resolution; ``labels`` maps label name -> (B, 8, 2) pixels (-1 padded)."""
    s = spec.image_size
    out: Dict[str, Any] = {}
    first = next(x for x in (rgb, depth, mask) if x is not None)
    batch, in_size = first.shape[0], first.shape[1]

    if depth is not None:
        out["depth"] = _process_depth(spec, depth, mask)
    if mask is not None:
        out["mask"] = depth_ops.round_mask(_resize(mask.float(), s))[:, None]
    if rgb is not None:
        out["rgb"] = _process_rgb(spec, rgb, mask)
        raw = _resize(rgb.permute(0, 3, 1, 2).float(), s)
        out["raw_rgb"] = raw.round().clamp(0, 255).permute(0, 2, 3, 1).to(torch.uint8)

    if spec.n_context:
        t = spec.n_context
        in_frame = torch.arange(t, device=ctx_count.device)[None, :] < ctx_count[:, None]
        out["context_attention_mask"] = in_frame.to(torch.int32)
        flat_mask = (ctx_mask.reshape(batch * t, *ctx_mask.shape[2:])
                     if ctx_mask is not None else None)
        cd = _process_depth(spec, ctx_depth.reshape(batch * t, *ctx_depth.shape[2:]),
                            flat_mask).reshape(batch, t, 1, s, s)
        sel = in_frame[:, :, None, None, None]
        # padding frames are all-ones tensors
        out["depth_context"] = torch.where(sel, cd, torch.ones_like(cd))
        if spec.context_rgb and ctx_rgb is not None:
            cr = _process_rgb(spec, ctx_rgb.reshape(batch * t, *ctx_rgb.shape[2:]),
                              flat_mask).reshape(batch, t, 3, s, s)
            out["rgb_context"] = torch.where(sel, cr, torch.ones_like(cr))

    scale = in_size / s   # labels: input -> model resolution
    for k in spec.label_keys:
        lab = labels[k].float()
        valid = lab.amin(dim=-1) >= 0
        out[k] = torch.where(valid[..., None], lab / scale, lab)
    return out


class Processor:
    """Test-partition preprocessing. ``cfg`` is the ``processor`` config
    node; ``autoprocessor_name`` selects SigLIP normalization and the SigLIP
    tokenizer (``spm_asset``: a ``spiece.model`` path or bytes)."""

    def __init__(self, cfg, partition: str = "test",
                 max_context_length: Optional[int] = None,
                 autoprocessor_name: Optional[str] = None, spm_asset=None):
        if partition != "test":
            raise NotImplementedError("only the test partition is ported")
        cfg = dict(cfg)
        if cfg.get("requires_graph") or cfg.get("standardize_depth"):
            raise NotImplementedError(
                "graph features and depth standardization are not ported")
        self.cfg = cfg
        self.image_size = int(cfg["model_image_size"])
        self.max_context_length = max_context_length or 0
        self.process_context = max_context_length is not None
        self.autoprocessor_name = autoprocessor_name
        self.tokenize = build_tokenizer(autoprocessor_name, spm_asset=spm_asset)
        self._spec_base = dict(
            image_size=self.image_size,
            mask_depth=bool(cfg.get("mask_depth", True)),
            image_mean=tuple(cfg.get("image_mean", image_ops.CLIP_MEAN)),
            image_std=tuple(cfg.get("image_std", image_ops.CLIP_STD)),
            siglip_norm=autoprocessor_name is not None,
        )

    def make_raw(self, rgb=None, depth=None, mask=None, instruction=None,
                 context=None, **labels) -> Dict[str, Any]:
        """Fixed-schema raw record (host side). ``context`` is a list of
        dicts with depth/rgb/mask keys (latest last), truncated to
        ``max_context_length``; ``labels`` are pick/place pixel arrays."""
        raw: Dict[str, Any] = {}
        if rgb is not None:
            raw["rgb"] = np.asarray(rgb, np.uint8)
        if depth is not None:
            raw["depth"] = np.asarray(depth, np.float32)
        if mask is not None:
            raw["mask"] = np.asarray(mask, np.float32)
        if instruction is not None:
            raw["raw_instruction"] = instruction
            raw["instruction"] = self.tokenize(instruction)
        if self.process_context:
            t = self.max_context_length
            frames = list(context or [])[-t:]
            raw["ctx_count"] = np.int32(len(frames))
            if depth is not None:
                h, w = raw["depth"].shape
            else:
                h = w = self.image_size
            raw["ctx_depth"] = np.ones((t, h, w), np.float32)
            raw["ctx_mask"] = np.ones((t, h, w), np.float32)
            if rgb is not None:
                raw["ctx_rgb"] = np.ones((t, h, w, 3), np.uint8)
            for i, item in enumerate(frames):
                raw["ctx_depth"][i] = item["depth"]
                if item.get("mask") is not None:
                    raw["ctx_mask"][i] = item["mask"]
                if rgb is not None and "rgb" in item:
                    raw["ctx_rgb"][i] = item["rgb"]
        label_keys = sorted(k for k in labels if "pick" in k or "place" in k)
        raw["label_keys"] = tuple(label_keys)
        for k in label_keys:
            raw[k] = pad_label(labels[k])
        return raw

    def _spec(self, batch: Dict[str, Any]) -> _CoreSpec:
        return _CoreSpec(
            label_keys=tuple(batch.get("label_keys", ())),
            has_rgb="rgb" in batch,
            has_depth="depth" in batch,
            has_mask="mask" in batch,
            n_context=self.max_context_length if "ctx_depth" in batch else 0,
            context_rgb="ctx_rgb" in batch,
            **self._spec_base,
        )
