"""On-device image preprocessing: resize-as-matmul, normalize, composite.

Counterpart of bifold_tpu/ops/image.py:45-161. Separable resampling is two
matrix products (``R @ img @ C^T``) whose matrices reproduce PIL's bicubic
(Keys a=-0.5, support stretched when downscaling) and bilinear windows
exactly; the matrices are built host-side in numpy (this module keeps its
own copy of :func:`resample_matrix`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resample_matrix", "resize", "normalize", "composite_background",
           "SIGLIP_MEAN", "SIGLIP_STD", "CLIP_MEAN", "CLIP_STD",
           "GRAY_BACKGROUND"]

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
GRAY_BACKGROUND = 77.0  # the reference composites cloth over gray 77


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (PIL's BICUBIC uses a=-0.5)."""
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


@lru_cache(maxsize=64)
def resample_matrix(in_size: int, out_size: int, method: str = "bicubic",
                    antialias: bool = True, a: float = -0.5) -> np.ndarray:
    """(out_size, in_size) float32 1-D resampling matrix with PIL semantics:
    ``src = (dst + 0.5) * in/out - 0.5``, the tap window clipped to the image
    and renormalized (PIL's edge handling), the kernel stretched by the
    downscale factor under ``antialias``."""
    if method == "bicubic":
        kernel, support = (lambda x: _cubic_kernel(x, a)), 2.0
    elif method == "bilinear":
        kernel, support = _linear_kernel, 1.0
    else:
        raise ValueError(f"Unknown resample method {method!r}")
    scale = in_size / out_size
    filter_scale = max(scale, 1.0) if antialias else 1.0
    sup = support * filter_scale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - sup + 0.5), 0)
        xmax = min(int(center + sup + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        w = kernel((taps + 0.5 - center) / filter_scale)
        total = w.sum()
        if total != 0:
            w = w / total
        m[i, xmin:xmax] = w
    return m.astype(np.float32)


def resize(img: torch.Tensor, size: int, method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """Resize the trailing (H, W) dims of ``img`` to (size, size) with two
    matrix products, in float32 (integer inputs are promoted)."""
    x = img if img.is_floating_point() else img.float()
    in_h, in_w = x.shape[-2], x.shape[-1]
    if in_h != size:
        r = torch.from_numpy(resample_matrix(in_h, size, method, antialias))
        x = torch.einsum("oh,...hw->...ow", r.to(x.device, x.dtype), x)
    if in_w != size:
        c = torch.from_numpy(resample_matrix(in_w, size, method, antialias))
        x = torch.einsum("ow,...hw->...ho", c.to(x.device, x.dtype), x)
    return x


def normalize(img: torch.Tensor, mean, std, scale: float = 1.0 / 255.0):
    """uint8-range (..., C, H, W) image -> (img*scale - mean) / std, f32."""
    mean = torch.tensor(mean, dtype=torch.float32, device=img.device)[:, None, None]
    std = torch.tensor(std, dtype=torch.float32, device=img.device)[:, None, None]
    return (img.float() * scale - mean) / std


def composite_background(rgb: torch.Tensor, mask: torch.Tensor,
                         background: float = GRAY_BACKGROUND) -> torch.Tensor:
    """Composite uint8 (..., C, H, W) rgb over a flat background where
    ``mask`` (..., H, W) is 0, truncating back to uint8 like the reference."""
    mask = mask[..., None, :, :].float()
    out = rgb.float() * mask + (1 - mask) * background
    return out.to(torch.uint8)
