"""Plain preprocessing of the reference: raw frames to model inputs.

A frozen copy of the port's plain image pipeline (``bifold_tpu_torch``
``data/processor.py:_core`` and ``ops/{image,depth,augment,gaussmap}.py``),
kept here so that the reference imports nothing of the program: gray-77
composite with uint8 truncation, PIL's bicubic resize as two matrix
products, SigLIP or CLIP normalisation, masked depth, rounded mask, context
frames with their mask, label scaling, the joint spatial augmentation of
images and label pixels (first accepted of the drawn trials, nearest
sampling, zero fill) and the Gaussian (gmm) heatmap targets. Everything is
float32 on whatever device the inputs live on.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

SIGLIP_MEAN = SIGLIP_STD = (0.5, 0.5, 0.5)
GRAY = 77.0
MAX_LABEL_POINTS = 8


def _cubic(x, a=-0.5):
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(x <= 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
                    np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0))


@lru_cache(maxsize=16)
def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 PIL bicubic resampling matrix, antialiased."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    sup = 2.0 * fscale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - sup + 0.5), 0)
        hi = min(int(center + sup + 0.5), in_size)
        taps = np.arange(lo, hi)
        w = _cubic((taps + 0.5 - center) / fscale)
        if w.sum() != 0:
            w = w / w.sum()
        m[i, lo:hi] = w
    return m.astype(np.float32)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    x = x.float()
    h, w = x.shape[-2], x.shape[-1]
    if h != size:
        r = torch.from_numpy(resample_matrix(h, size)).to(x.device)
        x = torch.einsum("oh,...hw->...ow", r, x)
    if w != size:
        c = torch.from_numpy(resample_matrix(w, size)).to(x.device)
        x = torch.einsum("ow,...hw->...ho", c, x)
    return x


def process_rgb(rgb_u8, mask, size, mean, std):
    """uint8 (B, H, W, 3) over gray 77 where the mask is 0 -> (B, 3, S, S)."""
    rgb = rgb_u8.permute(0, 3, 1, 2).float()
    if mask is not None:
        m = mask[:, None].float()
        rgb = (rgb * m + (1 - m) * GRAY).to(torch.uint8).float()
    out = resize(rgb, size)
    mean = torch.tensor(mean, device=out.device)[:, None, None]
    std = torch.tensor(std, device=out.device)[:, None, None]
    return (out / 255.0 - mean) / std


def process_depth(depth, mask, size):
    d = depth.float()
    if mask is not None:
        d = d * mask.float()
    return resize(d, size)[:, None]


def aug_pixels(pix, angle, dx, dy, size):
    """(B, P, 2) [x, y] rotated by -angle about size / 2, then moved."""
    rad = torch.deg2rad(-angle.float())[:, None]
    c, s = torch.cos(rad), torch.sin(rad)
    p = pix.float() - size / 2.0
    x = p[..., 0] * c - p[..., 1] * s
    y = p[..., 0] * s + p[..., 1] * c
    return torch.stack([x + size / 2.0 + dx[:, None], y + size / 2.0 + dy[:, None]], -1)


def affine_nearest(img, angle, dx, dy):
    """Each sample's (B, ..., H, W) content rotated counter-clockwise by
    ``angle`` degrees about the centre, then moved; nearest, zero fill."""
    b, h, w = img.shape[0], img.shape[-2], img.shape[-1]
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    rad = torch.deg2rad(angle.float())[:, None, None]
    c, s = torch.cos(rad), torch.sin(rad)
    xo = xs - (w - 1) / 2.0 - dx.float()[:, None, None]
    yo = ys - (h - 1) / 2.0 - dy.float()[:, None, None]
    xi = torch.round(c * xo - s * yo + (w - 1) / 2.0).long()
    yi = torch.round(s * xo + c * yo + (h - 1) / 2.0).long()
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, h * w)
    flat = img.reshape(b, -1, h * w)
    vals = torch.gather(flat, 2, idx.expand(-1, flat.shape[1], -1)).reshape(img.shape)
    inside = inside.reshape(b, *([1] * (img.dim() - 3)), h, w)
    return torch.where(inside, vals, torch.zeros_like(vals))


def augment(images: dict, pix, valid, angles, dxs, dys, size_px: int):
    """The first trial whose valid pixels all stay in [0, S - 1) per sample,
    else the identity; images and pixels move together."""
    size = size_px - 1
    b, t = angles.shape
    trial = torch.stack([aug_pixels(pix, angles[:, i], dxs[:, i], dys[:, i], size)
                         for i in range(t)], dim=1)                 # (B, T, P, 2)
    inframe = ((trial >= 0) & (trial < size)).all(-1)
    ok = torch.where(valid[:, None, :], inframe, True).all(-1)       # (B, T)
    accepted = ok.any(1)
    first = ok.int().argmax(1)
    rows = torch.arange(b, device=pix.device)
    zero = torch.zeros(b, device=pix.device)
    angle = torch.where(accepted, angles[rows, first], zero)
    dx = torch.where(accepted, dxs[rows, first], zero)
    dy = torch.where(accepted, dys[rows, first], zero)
    chosen = trial[rows, first]
    out_pix = torch.where((accepted[:, None] & valid)[..., None], chosen, pix.float())
    return {k: affine_nearest(v, angle, dx, dy) for k, v in images.items()}, out_pix


def gmm_heatmap(points, valid, size, sigma):
    """(B, P, 2) points -> (B, S, S): the sum of Gaussians at the rounded
    valid points, scaled to max 1 (zero where no point is valid)."""
    grid = torch.arange(size, dtype=torch.float32, device=points.device)
    cx = torch.round(points[..., 0])[..., None]
    cy = torch.round(points[..., 1])[..., None]
    inv = 1.0 / (2.0 * sigma * sigma)
    fx = torch.exp(-((grid - cx) ** 2) * inv)
    fy = torch.exp(-((grid - cy) ** 2) * inv) * valid.float()[..., None]
    m = torch.einsum("bnh,bnw->bhw", fy, fx)
    peak = m.amax(dim=(1, 2), keepdim=True)
    return torch.where(peak > 0, m / torch.where(peak > 0, peak, 1.0), m)


def process(cfg: dict, raw: dict, draws: dict | None, train: bool, device) -> dict:
    """The model inputs of one raw batch (numpy, leading dim B, the
    program's raw schema) on ``device``; ``draws`` the augmentation trials
    (angles, dxs, dys) when ``train``."""
    pcfg = cfg["processor"]
    s = int(pcfg["model_image_size"])
    siglip = cfg.get("autoprocessor_name") is not None
    mean = SIGLIP_MEAN if siglip else tuple(pcfg["image_mean"])
    std = SIGLIP_STD if siglip else tuple(pcfg["image_std"])
    x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in raw.items() if isinstance(v, np.ndarray)}
    b, in_size = x["rgb"].shape[0], x["rgb"].shape[1]
    out = {"depth": process_depth(x["depth"], x["mask"], s),
           "mask": torch.round(resize(x["mask"], s))[:, None],
           "rgb": process_rgb(x["rgb"], x["mask"], s, mean, std),
           "instruction": x["instruction"]}
    raw_rgb = resize(x["rgb"].permute(0, 3, 1, 2).float(), s)
    if "ctx_depth" in x:
        t = x["ctx_depth"].shape[1]
        in_frame = torch.arange(t, device=device)[None] < x["ctx_count"][:, None]
        out["context_attention_mask"] = in_frame.to(torch.int32)
        flat = x["ctx_mask"].reshape(b * t, *x["ctx_mask"].shape[2:])
        cd = process_depth(x["ctx_depth"].reshape(b * t, *x["ctx_depth"].shape[2:]),
                           flat, s).reshape(b, t, 1, s, s)
        sel = in_frame[:, :, None, None, None]
        out["depth_context"] = torch.where(sel, cd, torch.ones_like(cd))
        cr = process_rgb(x["ctx_rgb"].reshape(b * t, *x["ctx_rgb"].shape[2:]), flat,
                         s, mean, std).reshape(b, t, 3, s, s)
        out["rgb_context"] = torch.where(sel, cr, torch.ones_like(cr))
    keys = tuple(raw.get("label_keys", ()))
    scaled = {}
    for k in keys:
        lab = x[k].float()
        ok = lab.amin(-1) >= 0
        scaled[k] = torch.where(ok[..., None], lab / (in_size / s), lab)
    if train and keys and pcfg.get("spatial_augment", True):
        allpix = torch.cat([scaled[k] for k in keys], dim=1)
        warp = {"rgb": out["rgb"], "depth": out["depth"], "raw_rgb": raw_rgb}
        for k in ("rgb_context", "depth_context"):
            if k in out:
                warp[k] = out[k]
        images, allpix = augment(warp, allpix, allpix.amin(-1) >= 0, draws["angles"],
                                 draws["dxs"], draws["dys"], s)
        out.update({k: v for k, v in images.items() if k != "raw_rgb"})
        for i, k in enumerate(keys):
            scaled[k] = allpix[:, i * MAX_LABEL_POINTS:(i + 1) * MAX_LABEL_POINTS]
    for k in keys:
        out[k] = scaled[k]
        if train:
            out[f"{k}_heatmap"] = gmm_heatmap(scaled[k], scaled[k].amin(-1) >= 0, s,
                                              float(pcfg.get("sigma", 5.0)))
    return out
