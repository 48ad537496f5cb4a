"""Joint spatial augmentation of images and label pixels, batched.

Counterpart of bifold_tpu/ops/augment.py:30-146. Each sample takes the
first of its ``T`` trial draws ``(angle, dx, dy)`` whose valid label pixels
all stay inside ``[0, image_size - 1)``; when no trial does, the identity
applies. The draws are arguments, (B, T) tensors, so a caller (the train
Processor, from its generator) or a test (the JAX package's draws) supplies
them.

Conventions, as the JAX package's:

- pixels are ``[x, y]`` and rotate by ``-angle`` about ``(image_size - 1) / 2``
  then translate by ``(+dx, +dy)``;
- images warp like torchvision's ``affine(angle, translate=[dx, dy])``:
  centre ``((W - 1) / 2, (H - 1) / 2)``, zero fill, nearest (default) or
  bilinear.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["aug_pixels", "affine_warp", "spatial_augment"]


def aug_pixels(pixels, angle_deg, dx, dy, size):
    """(B, ..., N, 2) pixels under per-sample (B,) angle, dx, dy: rotate by
    -angle about size / 2 (callers pass size = image_size - 1), translate."""
    view = (-1,) + (1,) * (pixels.dim() - 1)
    rad = torch.deg2rad(-angle_deg.float()).reshape(view)
    c, s = torch.cos(rad), torch.sin(rad)
    p = pixels.float() - size / 2.0
    x = p[..., 0:1] * c - p[..., 1:2] * s     # p @ R^T, R = [[c, -s], [s, c]]
    y = p[..., 0:1] * s + p[..., 1:2] * c
    p = torch.cat([x, y], dim=-1) + size / 2.0
    return p + torch.stack([dx.float(), dy.float()], dim=-1).reshape(
        view[:-1] + (2,))


def affine_warp(img, angle_deg, dx, dy, order: str = "nearest"):
    """Rotate each sample's (B, ..., H, W) image content by its ``angle``
    degrees counter-clockwise about the centre, then translate by (dx right,
    dy down); zero fill, output in the input dtype."""
    b, h, w = img.shape[0], img.shape[-2], img.shape[-1]
    dev = img.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    rad = torch.deg2rad(angle_deg.float())[:, None, None]
    c, s = torch.cos(rad), torch.sin(rad)
    xo = xs - cx - dx.float()[:, None, None]
    yo = ys - cy - dy.float()[:, None, None]
    xi = c * xo - s * yo + cx                            # (B, H, W)
    yi = s * xo + c * yo + cy
    flat = img.reshape(b, -1, h * w)

    def gather(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, 1, h * w)
        vals = torch.gather(flat, 2, idx.expand(-1, flat.shape[1], -1))
        return vals.reshape(img.shape), inb.reshape(b, *([1] * (img.dim() - 3)), h, w)

    if order == "nearest":
        vals, inb = gather(torch.round(yi).long(), torch.round(xi).long())
        out = torch.where(inb, vals, torch.zeros_like(vals))
    elif order == "bilinear":
        x0, y0 = torch.floor(xi), torch.floor(yi)
        wx, wy = xi - x0, yi - y0
        out = 0.0
        for oy, wgt_y in ((0, 1.0 - wy), (1, wy)):
            for ox, wgt_x in ((0, 1.0 - wx), (1, wx)):
                vals, inb = gather((y0 + oy).long(), (x0 + ox).long())
                wgt = (wgt_y * wgt_x).reshape(inb.shape)
                out = out + torch.where(inb, vals * wgt, 0.0)
    else:
        raise ValueError(f"Unknown interpolation order {order!r}")
    return out.to(img.dtype)


def spatial_augment(images: Dict[str, torch.Tensor], pixels, pixels_valid,
                    angles, dxs, dys, *, image_size: int, order: str = "nearest"):
    """Augment a dict of (B, ..., H, W) images and (B, P, 2) label pixels
    together. ``pixels_valid`` (B, P) bool: invalid entries (the -1 padding)
    neither constrain acceptance nor move. ``angles``, ``dxs``, ``dys``:
    (B, T) trial draws. Returns (images, pixels, accepted (B,) bool)."""
    size = image_size - 1
    pix = pixels.float()
    valid = pixels_valid.bool()
    t = angles.shape[1]
    trial = aug_pixels(pix[:, None].expand(-1, t, -1, -1).reshape(-1, *pix.shape[1:]),
                       angles.reshape(-1), dxs.reshape(-1), dys.reshape(-1), size)
    trial = trial.reshape(pix.shape[0], t, *pix.shape[1:])      # (B, T, P, 2)
    inframe = (trial >= 0.0) & (trial < size)
    ok = torch.where(valid[:, None, :, None], inframe, True).all(dim=-1).all(dim=-1)
    accepted = ok.any(dim=1)
    first = ok.int().argmax(dim=1)                               # first True
    pick = lambda x: torch.gather(x, 1, first[:, None])[:, 0]   # noqa: E731
    zero = torch.zeros_like(angles[:, 0])
    angle = torch.where(accepted, pick(angles), zero)
    dx = torch.where(accepted, pick(dxs), zero)
    dy = torch.where(accepted, pick(dys), zero)
    chosen = trial[torch.arange(pix.shape[0], device=pix.device), first]
    out_pix = torch.where((accepted[:, None] & valid)[..., None], chosen, pix)
    out_images = {k: affine_warp(v, angle, dx, dy, order) for k, v in images.items()}
    return out_images, out_pix, accepted
