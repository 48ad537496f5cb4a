"""Depth-map transforms the test-partition processor needs.

Counterpart of bifold_tpu/ops/depth.py:27-31 and :77-79.
"""

from __future__ import annotations

import torch

__all__ = ["mask_depth", "round_mask"]


def mask_depth(depth: torch.Tensor, mask: torch.Tensor | None = None):
    """Zero out background depth (reference MaskDepth)."""
    return depth if mask is None else depth * mask.to(depth.dtype)


def round_mask(mask: torch.Tensor) -> torch.Tensor:
    """Round a resized soft mask back to {0, 1} (half to even, like jnp)."""
    return torch.round(mask)
