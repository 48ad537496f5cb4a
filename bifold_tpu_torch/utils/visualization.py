"""Prediction visualization: heatmap overlays, action arrows, rollout dumps.

The port's copy of bifold_tpu/utils/visualization.py, a counterpart of the
reference's utils/visualization.py: per-key subfolders of rgb /
colormapped+alpha-blended heatmaps / GT-vs-pred arrow overlays (GT
red/green circles+arrows, predictions blue/cyan) / particle positions.
Arrays in, files out — tensors are converted up front.

How the port differs: it needs no cv2, Pillow or matplotlib (the card's
host has none of them).

- PNGs come from a small writer on stdlib ``zlib`` (8-bit, filter 0):
  :func:`write_png`. They decode to the arrays written.
- ``viridis`` is the port's own 256-entry table (:data:`VIRIDIS`,
  matplotlib's ``viridis`` colors times 255, truncated to uint8 as the JAX
  package truncates them), indexed as matplotlib's ``Colormap.__call__``
  indexes a float array: ``min(int(v * 256), 255)`` for v in [0, 1], NaN
  black.
- The heatmap overlay reproduces ``PIL.Image.blend(rgb, heatmap,
  alpha=0.3)``'s uint8 arithmetic: ``uint8(rgb + 0.3f * (heatmap - rgb))``
  in float32, truncated.
- The marks are drawn in numpy, not by cv2's rasteriser: a pick circle
  (``cv2.circle`` radius 3, thickness 2) is the ring of pixels whose
  centres lie 2 to 4.5 px from the pick; a line of thickness 2 is the
  pixels within 1.45 px of the segment; an arrow is its line and the two
  head strokes at cv2's tip points (``cv2.arrowedLine``, tip length 0.1).
  Pixels more than 3 px from a mark equal cv2's image; the mark pixels
  cover most of cv2's (tests/test_torch_visualization.py holds the
  bound).
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

from bifold_tpu_torch.env.action import Action

__all__ = ["save_predictions", "visualize_action", "write_png", "apply_colormap",
           "blend", "VIRIDIS"]

VIRIDIS = np.array([
    (68, 1, 84), (68, 2, 85), (68, 3, 87), (69, 5, 88),
    (69, 6, 90), (69, 8, 91), (70, 9, 92), (70, 11, 94),
    (70, 12, 95), (70, 14, 97), (71, 15, 98), (71, 17, 99),
    (71, 18, 101), (71, 20, 102), (71, 21, 103), (71, 22, 105),
    (71, 24, 106), (72, 25, 107), (72, 26, 108), (72, 28, 110),
    (72, 29, 111), (72, 30, 112), (72, 32, 113), (72, 33, 114),
    (72, 34, 115), (72, 35, 116), (71, 37, 117), (71, 38, 118),
    (71, 39, 119), (71, 40, 120), (71, 42, 121), (71, 43, 122),
    (71, 44, 123), (70, 45, 124), (70, 47, 124), (70, 48, 125),
    (70, 49, 126), (69, 50, 127), (69, 52, 127), (69, 53, 128),
    (69, 54, 129), (68, 55, 129), (68, 57, 130), (67, 58, 131),
    (67, 59, 131), (67, 60, 132), (66, 61, 132), (66, 62, 133),
    (66, 64, 133), (65, 65, 134), (65, 66, 134), (64, 67, 135),
    (64, 68, 135), (63, 69, 135), (63, 71, 136), (62, 72, 136),
    (62, 73, 137), (61, 74, 137), (61, 75, 137), (61, 76, 137),
    (60, 77, 138), (60, 78, 138), (59, 80, 138), (59, 81, 138),
    (58, 82, 139), (58, 83, 139), (57, 84, 139), (57, 85, 139),
    (56, 86, 139), (56, 87, 140), (55, 88, 140), (55, 89, 140),
    (54, 90, 140), (54, 91, 140), (53, 92, 140), (53, 93, 140),
    (52, 94, 141), (52, 95, 141), (51, 96, 141), (51, 97, 141),
    (50, 98, 141), (50, 99, 141), (49, 100, 141), (49, 101, 141),
    (49, 102, 141), (48, 103, 141), (48, 104, 141), (47, 105, 141),
    (47, 106, 141), (46, 107, 142), (46, 108, 142), (46, 109, 142),
    (45, 110, 142), (45, 111, 142), (44, 112, 142), (44, 113, 142),
    (44, 114, 142), (43, 115, 142), (43, 116, 142), (42, 117, 142),
    (42, 118, 142), (42, 119, 142), (41, 120, 142), (41, 121, 142),
    (40, 122, 142), (40, 122, 142), (40, 123, 142), (39, 124, 142),
    (39, 125, 142), (39, 126, 142), (38, 127, 142), (38, 128, 142),
    (38, 129, 142), (37, 130, 142), (37, 131, 141), (36, 132, 141),
    (36, 133, 141), (36, 134, 141), (35, 135, 141), (35, 136, 141),
    (35, 137, 141), (34, 137, 141), (34, 138, 141), (34, 139, 141),
    (33, 140, 141), (33, 141, 140), (33, 142, 140), (32, 143, 140),
    (32, 144, 140), (32, 145, 140), (31, 146, 140), (31, 147, 139),
    (31, 148, 139), (31, 149, 139), (31, 150, 139), (30, 151, 138),
    (30, 152, 138), (30, 153, 138), (30, 153, 138), (30, 154, 137),
    (30, 155, 137), (30, 156, 137), (30, 157, 136), (30, 158, 136),
    (30, 159, 136), (30, 160, 135), (31, 161, 135), (31, 162, 134),
    (31, 163, 134), (32, 164, 133), (32, 165, 133), (33, 166, 133),
    (33, 167, 132), (34, 167, 132), (35, 168, 131), (35, 169, 130),
    (36, 170, 130), (37, 171, 129), (38, 172, 129), (39, 173, 128),
    (40, 174, 127), (41, 175, 127), (42, 176, 126), (43, 177, 125),
    (44, 177, 125), (46, 178, 124), (47, 179, 123), (48, 180, 122),
    (50, 181, 122), (51, 182, 121), (53, 183, 120), (54, 184, 119),
    (56, 185, 118), (57, 185, 118), (59, 186, 117), (61, 187, 116),
    (62, 188, 115), (64, 189, 114), (66, 190, 113), (68, 190, 112),
    (69, 191, 111), (71, 192, 110), (73, 193, 109), (75, 194, 108),
    (77, 194, 107), (79, 195, 105), (81, 196, 104), (83, 197, 103),
    (85, 198, 102), (87, 198, 101), (89, 199, 100), (91, 200, 98),
    (94, 201, 97), (96, 201, 96), (98, 202, 95), (100, 203, 93),
    (103, 204, 92), (105, 204, 91), (107, 205, 89), (109, 206, 88),
    (112, 206, 86), (114, 207, 85), (116, 208, 84), (119, 208, 82),
    (121, 209, 81), (124, 210, 79), (126, 210, 78), (129, 211, 76),
    (131, 211, 75), (134, 212, 73), (136, 213, 71), (139, 213, 70),
    (141, 214, 68), (144, 214, 67), (146, 215, 65), (149, 215, 63),
    (151, 216, 62), (154, 216, 60), (157, 217, 58), (159, 217, 56),
    (162, 218, 55), (165, 218, 53), (167, 219, 51), (170, 219, 50),
    (173, 220, 48), (175, 220, 46), (178, 221, 44), (181, 221, 43),
    (183, 221, 41), (186, 222, 39), (189, 222, 38), (191, 223, 36),
    (194, 223, 34), (197, 223, 33), (199, 224, 31), (202, 224, 30),
    (205, 224, 29), (207, 225, 28), (210, 225, 27), (212, 225, 26),
    (215, 226, 25), (218, 226, 24), (220, 226, 24), (223, 227, 24),
    (225, 227, 24), (228, 227, 24), (231, 228, 25), (233, 228, 25),
    (236, 228, 26), (238, 229, 27), (241, 229, 28), (243, 229, 30),
    (246, 230, 31), (248, 230, 33), (250, 230, 34), (253, 231, 36)
], np.uint8)
_COLORMAPS = {"viridis": VIRIDIS}
_RING = (2.0, 4.5)        # the pick circle's pixel-centre distances
_HALF_WIDTH = 1.45        # a thickness-2 line's reach from its segment
_TIP_LENGTH = 0.1         # cv2.arrowedLine's default


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA array as
    a PNG (one IDAT chunk, filter 0 on every row)."""
    img = np.ascontiguousarray(_np(img).astype(np.uint8))
    channels = 1 if img.ndim == 2 else img.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def apply_colormap(val, name: str = "viridis") -> np.ndarray:
    """(H, W) values in [0, 1] (clipped) -> (H, W, 3) uint8 colors."""
    lut = _COLORMAPS[name]
    v = np.clip(_np(val).squeeze(), 0.0, 1.0)
    n = len(lut)
    scaled = v * v.dtype.type(n) if v.dtype.kind == "f" else v * n
    idx = np.where(scaled == n, n - 1, np.nan_to_num(scaled)).astype(int)
    out = lut[np.clip(idx, 0, n - 1)]
    out[np.isnan(scaled)] = 0
    return out


def blend(a: np.ndarray, b: np.ndarray, alpha: float = 0.3) -> np.ndarray:
    """``PIL.Image.blend(a, b, alpha)`` on uint8 arrays."""
    a = a.astype(np.int32)
    d = (b.astype(np.int32) - a).astype(np.float32)
    return (a.astype(np.float32) + np.float32(alpha) * d).astype(np.uint8)


def save_predictions(out_folder: str, out_file_name: str, rgb=None,
                     colormap: str = "viridis", **kwargs) -> None:
    """Save each named artifact into its own subfolder
    (reference visualization.py:10-46)."""
    rgb_img: Optional[np.ndarray] = None
    if rgb is not None:
        folder = os.path.join(out_folder, "rgb")
        os.makedirs(folder, exist_ok=True)
        rgb_img = _np(rgb).astype(np.uint8)
        write_png(os.path.join(folder, out_file_name), rgb_img)

    for k, val in kwargs.items():
        if val is None:
            continue
        folder = os.path.join(out_folder, k)
        os.makedirs(folder, exist_ok=True)
        if "heatmap" in k or k == "depth":
            arr = _np(val).squeeze()
            if arr.ndim <= 1:
                continue
            if k == "depth":
                rng = arr.max() - arr.min()
                arr = (arr - arr.min()) / (rng if rng > 0 else 1.0)
            heatmap = apply_colormap(arr, colormap)
            if rgb_img is not None and "heatmap" in k:
                write_png(os.path.join(folder, out_file_name), blend(rgb_img, heatmap))
            else:
                write_png(os.path.join(folder, out_file_name), heatmap)
        elif k == "particle_pos":
            np.save(os.path.join(folder, out_file_name.replace(".png", ".npy")),
                    _np(val))
        elif k in ("viz", "rgb_gt"):
            write_png(os.path.join(folder, out_file_name), _np(val).astype(np.uint8))
        else:
            raise ValueError(f"Unrecognized argument {k}")


def _grid(img: np.ndarray):
    ys, xs = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    return xs.astype(np.float64), ys.astype(np.float64)


def _stroke(img: np.ndarray, p0, p1, color) -> None:
    """A line of thickness 2 from p0 to p1 (integer pixels), round ends."""
    xs, ys = _grid(img)
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    length2 = dx * dx + dy * dy
    t = (np.clip(((xs - x0) * dx + (ys - y0) * dy) / length2, 0.0, 1.0)
         if length2 else 0.0)
    img[np.hypot(xs - x0 - t * dx, ys - y0 - t * dy) <= _HALF_WIDTH] = color


def _circle(img: np.ndarray, center, color) -> None:
    xs, ys = _grid(img)
    d = np.hypot(xs - center[0], ys - center[1])
    img[(d >= _RING[0]) & (d <= _RING[1])] = color


def _arrow(img: np.ndarray, p0, p1, color) -> None:
    """cv2.arrowedLine's line and head strokes (its tip points, rounded)."""
    _stroke(img, p0, p1, color)
    angle = math.atan2(p0[1] - p1[1], p0[0] - p1[0])
    tip = math.hypot(p0[0] - p1[0], p0[1] - p1[1]) * _TIP_LENGTH
    for side in (1, -1):
        a = angle + side * math.pi / 4
        _stroke(img, p1, (round(p1[0] + tip * math.cos(a)),
                          round(p1[1] + tip * math.sin(a))), color)


def _pick_place_viz(img: np.ndarray, picks, places, color) -> np.ndarray:
    picks = _np(picks).reshape(-1, 2)
    places = _np(places).reshape(-1, 2)
    for pick, place in zip(picks, places):
        p0 = (round(float(pick[0])), round(float(pick[1])))
        if pick[0] >= 0:
            _circle(img, p0, color)
        if place[0] >= 0:
            _arrow(img, p0, (round(float(place[0])), round(float(place[1]))), color)
    return img


def visualize_action(sample: Dict, action: Action) -> List[np.ndarray]:
    """GT (red/green) vs predicted (blue/cyan) pick->place arrows over raw_rgb
    (reference visualization.py:49-106)."""
    gt_colors = [(255, 0, 0), (0, 255, 0)]
    pred_colors = [(0, 0, 255), (0, 255, 255)]
    raw = _np(sample["raw_rgb"])
    batched = raw.ndim == 4
    frames = raw if batched else raw[None]

    images = []
    for i, img in enumerate(frames):
        img = np.ascontiguousarray(img.astype(np.uint8))

        def get(key):
            if key not in sample:
                return None
            v = _np(sample[key])
            return v[i] if batched and v.ndim >= 2 and len(v) == len(frames) else v

        if not action.is_bimanual:
            gt_pick, gt_place = get("pick"), get("place")
            if gt_pick is not None and gt_place is not None:
                img = _pick_place_viz(img, gt_pick, gt_place, gt_colors[0])
            img = _pick_place_viz(img, _np(action.pick).reshape(-1, 2)[i],
                                  _np(action.place).reshape(-1, 2)[i],
                                  pred_colors[0])
        else:
            for arm, gt_c, pred_c in zip(("left", "right"), gt_colors, pred_colors):
                gt_pick, gt_place = get(f"{arm}_pick"), get(f"{arm}_place")
                if gt_pick is not None and gt_place is not None:
                    img = _pick_place_viz(img, gt_pick, gt_place, gt_c)
                img = _pick_place_viz(
                    img,
                    _np(getattr(action, f"{arm}_pick")).reshape(-1, 2)[i],
                    _np(getattr(action, f"{arm}_place")).reshape(-1, 2)[i],
                    pred_c)
        images.append(img)
    return images
