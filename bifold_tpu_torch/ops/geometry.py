"""Camera geometry: intrinsics, world->camera extrinsics, and the pixel /
world transforms of the graph features.

The port's copies of bifold_tpu/ops/geometry.py:26 (``intrinsic_from_fov``),
:38 (``rotation_matrix_4x4``) and :60 (``matrix_world_to_camera``), in
numpy, and of :76 (``world_from_pixel``), :98 (``world_coords_from_depth``)
and :113 (``pixel_from_world``) in float32 torch on the tensors' device, as
JAX computes them with x64 off. The extrinsic's inverse is JAX's: scipy's
LAPACK LU factorisation and solve in float32 on the host (the routines
``jnp.linalg.inv`` calls on the CPU), so the inverse matches JAX's bit for
bit and the graph features built on it do too.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["intrinsic_from_fov", "rotation_matrix_4x4", "matrix_world_to_camera",
           "world_from_pixel", "world_coords_from_depth", "pixel_from_world"]


def intrinsic_from_fov(height: int, width: int, fov: float = 90.0) -> np.ndarray:
    """Pinhole intrinsics (4x4) from a horizontal field of view in degrees."""
    px, py = width / 2.0, height / 2.0
    hfov = fov / 360.0 * 2.0 * np.pi
    fx = width / (2.0 * np.tan(hfov / 2.0))
    vfov = 2.0 * np.arctan(np.tan(hfov / 2.0) * height / width)
    fy = height / (2.0 * np.tan(vfov / 2.0))
    return np.array(
        [[fx, 0, px, 0.0], [0, fy, py, 0.0], [0, 0, 1.0, 0.0], [0, 0, 0, 1.0]]
    )


def rotation_matrix_4x4(angle: float, axis) -> np.ndarray:
    """Axis-angle rotation as a 4x4 homogeneous matrix (Rodrigues form), in
    the reference's sign convention: the transpose of the usual right-handed
    matrix (a rotation by ``-angle``)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    s, c = np.sin(angle), np.cos(angle)
    m = np.eye(4)
    m[:3, :3] = np.array(
        [
            [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
            [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
        ]
    )
    return m


def matrix_world_to_camera(cam_pos, cam_angle) -> np.ndarray:
    """World->camera extrinsics from the SoftGym camera pose:
    ``cam_angle = (x_angle, y_angle)`` in radians, yaw about world-Y then
    pitch about camera-X, with the reference's extra pi flip."""
    cam_x, cam_y, cam_z = cam_pos
    cam_x_angle, cam_y_angle = cam_angle[0], cam_angle[1]
    m1 = rotation_matrix_4x4(-cam_x_angle, [0, 1, 0])
    m2 = rotation_matrix_4x4(-cam_y_angle - np.pi, [1, 0, 0])
    rotation = m2 @ m1
    translation = np.eye(4)
    translation[:3, 3] = [-cam_x, -cam_y, -cam_z]
    return rotation @ translation


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32, device=device)


def _inverse(m, device) -> torch.Tensor:
    """float32 inverse of a 4x4 matrix: LAPACK's LU with partial pivoting
    and its solve against the identity, in float32."""
    from scipy.linalg import lu_factor, lu_solve

    a = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, np.float32)
    inv = lu_solve(lu_factor(a), np.eye(a.shape[0], dtype=np.float32))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def world_from_pixel(pixel_xy, depth, m_world_to_camera, K) -> torch.Tensor:
    """Unproject one ``[x, y]`` pixel to a world-space 3-vector, with the
    reference's indexing quirk ``z = depth[round(x), round(y)]`` (rounded
    half to even, clipped to the map)."""
    depth = _f32(depth)
    pixel_xy, K = _f32(pixel_xy, depth.device), _f32(K, depth.device)
    u, v = pixel_xy[0], pixel_xy[1]
    ui = int(torch.round(u).to(torch.int32).clamp(0, depth.shape[0] - 1))
    vi = int(torch.round(v).to(torch.int32).clamp(0, depth.shape[1] - 1))
    z = depth[ui, vi]
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    cam = torch.stack([x, y, z, torch.ones_like(z)])
    return (_inverse(m_world_to_camera, depth.device) @ cam)[:3]


def world_coords_from_depth(depth, m_world_to_camera, K) -> torch.Tensor:
    """Back-project an (H, W) depth map to (H, W, 4) homogeneous world
    coordinates."""
    depth = _f32(depth)
    K = _f32(K, depth.device)
    h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - K[0, 2]) * depth / K[0, 0]
    y = (v - K[1, 2]) * depth / K[1, 1]
    cam = torch.stack([x, y, depth, torch.ones_like(depth)], dim=-1)[..., None, :]
    inv = _inverse(m_world_to_camera, depth.device)
    # the four products summed in pairs, the order XLA's CPU dot sums them
    return ((cam[..., 0] * inv[:, 0] + cam[..., 1] * inv[:, 1])
            + (cam[..., 2] * inv[:, 2] + cam[..., 3] * inv[:, 3]))


def pixel_from_world(coords, m_world_to_camera, K) -> torch.Tensor:
    """Project (N, 3) world points to a (2, N) ``[u; v]`` pixel array."""
    coords = _f32(coords)
    m, K = _f32(m_world_to_camera, coords.device), _f32(K, coords.device)
    homo = torch.cat([coords, torch.ones((coords.shape[0], 1), device=coords.device)], 1)
    cam = (m @ homo.T).T
    x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
    return torch.stack([x * K[0, 0] / z + K[0, 2], y * K[1, 1] / z + K[1, 2]])
