"""Procedural garment meshes (tshirt, trousers) with semantic keypoints.

The port's copy of bifold_tpu/env/garments.py. The reference gets garment geometry from the CLOTH3D dataset via
create_softgym_meshes.py (external download + FleX dedup); for a
self-contained eval loop we generate grid-sampled silhouettes with the same
keypoint index semantics the demonstrators script against
(env/demonstrators.py docstring): tshirt 0-7 = shoulders/sleeves/chest/hems,
trousers 0-7 = waist row + hem row. Real CLOTH3D .obj meshes can still be
used by passing ``mesh_path`` configs (env/cloth_env.py reset).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

__all__ = ["masked_grid_cloth", "tshirt_mesh", "trousers_mesh"]


def masked_grid_cloth(nx: int, nz: int, spacing: float,
                      inside: Callable[[np.ndarray, np.ndarray], np.ndarray]):
    """Grid cloth keeping only faces whose cell center satisfies ``inside``.

    Returns (vertices (N, 3) XZ-plane, faces (F, 3), keep_index mapping from
    full-grid vertex index -> compact index (or -1)).
    """
    xs = (np.arange(nx) - (nx - 1) / 2.0) * spacing
    zs = (np.arange(nz) - (nz - 1) / 2.0) * spacing
    xx, zz = np.meshgrid(xs, zs)
    verts_full = np.stack([xx, np.zeros_like(xx), zz], axis=-1).reshape(-1, 3)
    faces = []
    for j in range(nz - 1):
        for i in range(nx - 1):
            cx = (xs[i] + xs[i + 1]) / 2
            cz = (zs[j] + zs[j + 1]) / 2
            if not inside(np.asarray(cx), np.asarray(cz)):
                continue
            a = j * nx + i
            b = a + 1
            c = a + nx
            d = c + 1
            faces.append([a, b, c])
            faces.append([b, d, c])
    faces = np.asarray(faces, np.int64)
    used = np.unique(faces)
    remap = -np.ones(len(verts_full), np.int64)
    remap[used] = np.arange(len(used))
    return (verts_full[used].astype(np.float32), remap[faces], remap)


def _nearest_vertex(verts: np.ndarray, x: float, z: float) -> int:
    return int(np.argmin((verts[:, 0] - x) ** 2 + (verts[:, 2] - z) ** 2))


def tshirt_mesh(scale: float = 0.22, resolution: int = 33
                ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """T-shirt silhouette in the XZ plane (z = -: shoulders, z = +: hem).

    Keypoints (demonstrators convention): [left_shoulder, right_shoulder,
    left_sleeve, left_chest, right_chest, right_sleeve, left_hem, right_hem].
    """
    half = scale / 2

    def inside(cx, cz):
        x = cx / half
        z = cz / half
        body = (np.abs(x) < 0.55) & (z > -1.0) & (z < 1.0)
        # sleeves: upper band, extending sideways
        sleeve = (np.abs(x) >= 0.55) & (np.abs(x) < 1.0) & (z > -1.0) & (z < -0.35)
        return body | sleeve

    spacing = scale * 2 / (resolution - 1)
    verts, faces, _ = masked_grid_cloth(resolution, resolution, spacing, inside)
    kp = [
        _nearest_vertex(verts, -0.45 * half, -0.95 * half),  # 0 left shoulder
        _nearest_vertex(verts, 0.45 * half, -0.95 * half),   # 1 right shoulder
        _nearest_vertex(verts, -0.95 * half, -0.65 * half),  # 2 left sleeve tip
        _nearest_vertex(verts, -0.30 * half, -0.30 * half),  # 3 left chest
        _nearest_vertex(verts, 0.30 * half, -0.30 * half),   # 4 right chest
        _nearest_vertex(verts, 0.95 * half, -0.65 * half),   # 5 right sleeve tip
        _nearest_vertex(verts, -0.45 * half, 0.95 * half),   # 6 left hem
        _nearest_vertex(verts, 0.45 * half, 0.95 * half),    # 7 right hem
    ]
    return verts, faces, kp


def trousers_mesh(scale: float = 0.24, resolution: int = 33
                  ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Trousers silhouette (z = -: waist, z = +: hems).

    Keypoints: waist row left->right (0..3) then hem row left->right (4..7);
    the demonstrators fold leg columns [0,4]->[3,7] and waist 2 -> hem 6.
    """
    half = scale / 2

    def inside(cx, cz):
        x = cx / half
        z = cz / half
        waist = (np.abs(x) < 0.75) & (z > -1.0) & (z < -0.2)
        legs = (np.abs(x) > 0.15) & (np.abs(x) < 0.75) & (z >= -0.2) & (z < 1.0)
        return waist | legs

    spacing = scale * 2 / (resolution - 1)
    verts, faces, _ = masked_grid_cloth(resolution, resolution, spacing, inside)
    kp = [
        _nearest_vertex(verts, -0.70 * half, -0.95 * half),  # 0 waist far left
        _nearest_vertex(verts, -0.25 * half, -0.95 * half),  # 1 waist mid-left
        _nearest_vertex(verts, 0.25 * half, -0.95 * half),   # 2 waist mid-right
        _nearest_vertex(verts, 0.70 * half, -0.95 * half),   # 3 waist far right
        _nearest_vertex(verts, -0.70 * half, 0.95 * half),   # 4 left hem outer
        _nearest_vertex(verts, -0.25 * half, 0.95 * half),   # 5 left hem inner
        _nearest_vertex(verts, 0.25 * half, 0.95 * half),    # 6 right hem inner
        _nearest_vertex(verts, 0.70 * half, 0.95 * half),    # 7 right hem outer
    ]
    return verts, faces, kp
