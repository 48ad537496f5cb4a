"""Depth-map transforms: masking, shift, noise, standardization, mask rounding.

Counterpart of bifold_tpu/ops/depth.py:27-79. The random transforms take
their draws as arguments (the train Processor draws them from its
generator; tests hand in the JAX package's draws).
"""

from __future__ import annotations

import torch

__all__ = ["mask_depth", "depth_shift", "depth_noise",
           "truncated_standardization", "round_mask"]


def mask_depth(depth: torch.Tensor, mask: torch.Tensor | None = None):
    """Zero out background depth (reference MaskDepth)."""
    return depth if mask is None else depth * mask.to(depth.dtype)


def depth_shift(depth: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """A global depth shift: ``shift`` uniform in [min_shift, max_shift),
    broadcast against ``depth`` (one value per map)."""
    return depth + shift


def depth_noise(depth: torch.Tensor, normal_y: torch.Tensor,
                normal_x: torch.Tensor, normal_d: torch.Tensor,
                sigma_disparity: float = 0.005, sigma_spatial: float = 0.5):
    """Sensor noise on (..., H, W) maps: sample each map at integer
    coordinates jittered by round(N(0,1) * sigma_spatial) (``normal_y``,
    ``normal_x``, (..., H, W) standard normals), then add
    N(0,1) * sigma_disparity (``normal_d``) in disparity space where the
    depth is valid."""
    depth = depth.float()
    h, w = depth.shape[-2], depth.shape[-1]
    dy = torch.round(normal_y * sigma_spatial).long()
    dx = torch.round(normal_x * sigma_spatial).long()
    ys = (torch.arange(h, device=depth.device)[:, None] + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=depth.device)[None, :] + dx).clamp(0, w - 1)
    flat = depth.reshape(*depth.shape[:-2], h * w)
    wiggled = torch.gather(flat, -1, (ys * w + xs).reshape(flat.shape)).reshape(depth.shape)
    disparity = torch.where(wiggled > 0, 1.0 / wiggled.clamp_min(1e-6), 0.0)
    noisy_disp = disparity + normal_d * sigma_disparity
    noisy = torch.where(noisy_disp > 1e-6, 1.0 / noisy_disp.clamp_min(1e-6), 0.0)
    return torch.where(wiggled > 0, noisy, wiggled)


def truncated_standardization(depth: torch.Tensor, thresh: float = 0.1):
    """Standardize each map by the mean and variance of the central
    (1 - 2 thresh) of its sorted values. ``depth`` (B, ...), one map per
    leading index."""
    depth = depth.float()
    flat = torch.sort(depth.reshape(depth.shape[0], -1), dim=1).values
    n = flat.shape[1]
    trunc = flat[:, int(thresh * n): int((1 - thresh) * n)]
    mean = trunc.mean(dim=1)
    var = trunc.var(dim=1, unbiased=False)
    view = (-1,) + (1,) * (depth.dim() - 1)
    return (depth - mean.reshape(view)) / torch.sqrt(var.reshape(view) + 1e-6)


def round_mask(mask: torch.Tensor) -> torch.Tensor:
    """Round a resized soft mask back to {0, 1} (half to even, like jnp)."""
    return torch.round(mask)
