"""Tiny versions of the benchmark's cells for the CPU: the same files with
every width and depth cut, the flagship on the port's ``tiny`` SigLIP
towers, rgb_clip on a tiny CLIP (``CLIP_CONFIGS`` swapped while it runs)."""

from __future__ import annotations

import contextlib
import time

import torch

import run
from pb import cells

SEED = 2 ** 32 + 12345          # larger than 32 signed bits hold


def siglip(cell: str, dtype: str = "bfloat16") -> dict:
    c = cells.load_cell(cell)
    cfg = c["config_data"]
    cfg["model"].update(image_size=64, automodel_name="tiny", dim=64, r=2, depth=2, heads=4)
    cfg["towers"].update(layers=2, heads=4, mlp=256)
    cfg["processor"]["model_image_size"] = 64
    cfg["key_mask"] = {"head_dim": 16, "base": 82, "per_context_frame": 17}
    cfg["train"]["compute_dtype"] = cfg["serve"]["compute_dtype"] = dtype
    mix = c["traffic_data"]
    if mix["entry"] == "train_step":
        mix.update(batch=4, frame_px=96, label_px=[10, 80], cloth_px=48)
    else:
        mix.update(camera_px=96, cloth_px=48)
    c["trace_steps"] = 2
    return c


@contextlib.contextmanager
def tiny_clip():
    from bifold_tpu_torch.models.backbones import clip_backbone as cb

    old = cb.CLIP_CONFIGS["ViT-B/16"]
    cb.CLIP_CONFIGS["ViT-B/16"] = cb.ClipConfig(
        image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=4,
        text_width=64, text_layers=2, text_heads=4, embed_dim=64)
    try:
        yield
    finally:
        cb.CLIP_CONFIGS["ViT-B/16"] = old


def rgb_clip(dtype: str = "bfloat16") -> dict:
    c = cells.load_cell("rgb_clip.train_b256")
    cfg = c["config_data"]
    cfg["model"].update(image_size=64, depth=2, heads=4)
    cfg["towers"].update(vision_width=64, vision_layers=2, vision_heads=4, text_width=64,
                         text_layers=2, text_heads=4, embed_dim=64)
    cfg["processor"]["model_image_size"] = 64
    cfg["train"]["compute_dtype"] = dtype
    c["traffic_data"].update(batch=4, frame_px=64, label_px=[5, 58], cloth_px=32)
    c["trace_steps"] = 2
    return c


def run_tiny(cell: dict, seconds: float = 0.3, trace: int = 0, seed: int = SEED, **kw):
    """(record, result line) of one run on the CPU."""
    record = run.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), **kw)
    record["card"] = "cpu"
    return record, run.assemble(cell, record, trace, {"platform": "cpu", "kind": "cpu",
                                                      "count": 1})
