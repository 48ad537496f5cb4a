"""Gaussian heatmap targets, batched on the device.

Counterpart of bifold_tpu/ops/gaussmap.py:24-108. Points are ``[x, y]`` =
(column, row) with a validity mask; a map's peak lands at ``map[y, x]``.

- ``first``: one unnormalised Gaussian at the first valid point;
- ``gmm``: the sum over valid points, renormalised to max 1 (one point gives
  the ``first`` map);
- ``fit``: one bivariate normal fitted (mean, N-1 covariance + 1e-6 I) to
  the valid points, evaluated on the grid, unnormalised.

Centres are rounded half to even (``jnp.rint``) for ``first`` and ``gmm``;
a sample with no valid point gets a zero map.
"""

from __future__ import annotations

import math

import torch

__all__ = ["batched_gaussmap", "gaussmap"]


def _separable_gauss(points, valid, size, sigma):
    """(B, N, 2) rounded centres, (B, N) validity -> (B, size, size): the sum
    of exp(-d^2 / 2 sigma^2) as row x column factor products."""
    grid = torch.arange(size, dtype=torch.float32, device=points.device)
    cx = torch.round(points[..., 0])[..., None]          # (B, N, 1)
    cy = torch.round(points[..., 1])[..., None]
    inv = 1.0 / (2.0 * sigma * sigma)
    fx = torch.exp(-((grid - cx) ** 2) * inv)           # (B, N, W)
    fy = torch.exp(-((grid - cy) ** 2) * inv) * valid.float()[..., None]
    return torch.einsum("bnh,bnw->bhw", fy, fx)


def batched_gaussmap(points, valid, size: int, sigma: float = 5.0,
                     strategy: str = "gmm"):
    """points (B, N, 2) float, valid (B, N) bool -> (B, size, size) f32."""
    points = points.float().reshape(points.shape[0], -1, 2)
    valid = valid.bool().reshape(points.shape[0], -1)
    if strategy == "first":
        first = valid.int().argmax(dim=1, keepdim=True)   # 0 when none: masked
        idx = torch.arange(points.shape[1], device=points.device)[None]
        return _separable_gauss(points, valid & (idx == first), size, sigma)
    if strategy == "gmm":
        m = _separable_gauss(points, valid, size, sigma)
        peak = m.amax(dim=(1, 2), keepdim=True)
        return torch.where(peak > 0, m / torch.where(peak > 0, peak, 1.0), m)
    if strategy == "fit":
        w = valid.float()
        n_valid = w.sum(dim=1)                             # (B,)
        n = n_valid.clamp_min(1.0)
        mean = (points * w[..., None]).sum(dim=1) / n[:, None]
        centered = (points - mean[:, None]) * w[..., None]
        cov = centered.transpose(1, 2) @ centered / (n - 1.0).clamp_min(1.0)[:, None, None]
        cov = cov + 1e-6 * torch.eye(2, device=points.device)
        icov = torch.linalg.inv(cov)
        det = torch.linalg.det(cov)
        grid = torch.arange(size, dtype=torch.float32, device=points.device)
        dx = grid[None, None, :] - mean[:, 0, None, None]   # (B, 1, W)
        dy = grid[None, :, None] - mean[:, 1, None, None]   # (B, H, 1)
        quad = (icov[:, 0, 0, None, None] * dx ** 2
                + icov[:, 1, 1, None, None] * dy ** 2
                + (icov[:, 0, 1] + icov[:, 1, 0])[:, None, None] * dx * dy)
        m = torch.exp(-0.5 * quad) / (2.0 * math.pi * torch.sqrt(det))[:, None, None]
        return torch.where(n_valid[:, None, None] > 0, m, torch.zeros_like(m))
    raise ValueError(f"Strategy {strategy} not recognized")


def gaussmap(points, valid, size: int, sigma: float = 5.0, strategy: str = "gmm"):
    """One (size, size) map: :func:`batched_gaussmap` of a batch of one."""
    return batched_gaussmap(points[None], valid[None], size, sigma, strategy)[0]
