"""Heatmap -> action decoding: argmax, mask snapping, confidence gating.

Counterpart of bifold_tpu/ops/heatmap.py:32-104, batched on the device.
Returned pixels are ``[x, y]`` (column, row); ties resolve to the first
flat index (row-major), as ``jnp.argmax`` / ``jnp.argmin`` do.
"""

from __future__ import annotations

import torch

__all__ = ["DUMMY_PIXEL", "decode_heatmap", "nearest_to_mask", "gate_bimanual"]

DUMMY_PIXEL = -1.0  # "this arm does not act"
_INT32_MAX = 2 ** 31 - 1


def nearest_to_mask(pixels_rc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Snap (B, 2) ``[row, col]`` pixels to the nearest True pixel of the
    (B, H, W) mask; a row whose mask is all False keeps its pixel."""
    b, h, w = mask.shape
    rows = torch.arange(h, device=mask.device)[:, None]
    cols = torch.arange(w, device=mask.device)[None, :]
    pr = pixels_rc[:, 0][:, None, None]
    pc = pixels_rc[:, 1][:, None, None]
    d2 = (rows[None] - pr) ** 2 + (cols[None] - pc) ** 2
    d2 = torch.where(mask > 0, d2, torch.full_like(d2, _INT32_MAX))
    flat_idx = torch.argmin(d2.reshape(b, -1), dim=1)
    snapped = torch.stack([flat_idx // w, flat_idx % w], dim=1)
    has_mask = (mask > 0).flatten(1).any(dim=1)
    return torch.where(has_mask[:, None], snapped, pixels_rc.to(snapped.dtype))


def decode_heatmap(heatmap: torch.Tensor, mask: torch.Tensor | None = None,
                   *, use_mask: bool = False):
    """(B, H, W) heatmaps -> (``[x, y]`` pixels (B, 2) int64, conf (B,)).
    With ``use_mask`` the argmax snaps to the nearest mask pixel and the
    confidence is read there."""
    b, h, w = heatmap.shape
    flat = heatmap.reshape(b, -1)
    flat_idx = torch.argmax(flat, dim=1)
    rc = torch.stack([flat_idx // w, flat_idx % w], dim=1)
    if use_mask:
        if mask is None:
            raise ValueError("use_mask=True requires a mask")
        rc = nearest_to_mask(rc, mask.reshape(b, h, w))
    conf = torch.gather(flat, 1, (rc[:, 0] * w + rc[:, 1])[:, None])[:, 0]
    return torch.stack([rc[:, 1], rc[:, 0]], dim=1), conf


def gate_bimanual(left_pick, right_pick, left_place, right_place, left_conf,
                  right_conf, threshold: float = 0.5):
    """An arm acts iff its pick confidence >= threshold or it is the more
    confident arm; an idle arm's pick and place become DUMMY_PIXEL.
    Returns float32 pixel arrays."""
    conf = torch.stack([left_conf, right_conf])                 # (2, B)
    winner = torch.argmax(conf, dim=0)[None, :] == torch.arange(
        2, device=conf.device)[:, None]
    act = (conf >= threshold) | winner

    def apply(p, m):
        return torch.where(m[:, None], p.float(),
                           torch.full_like(p, DUMMY_PIXEL, dtype=torch.float32))

    return (apply(left_pick, act[0]), apply(right_pick, act[1]),
            apply(left_place, act[0]), apply(right_place, act[1]))
