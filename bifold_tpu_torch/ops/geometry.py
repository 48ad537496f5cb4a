"""Camera geometry the datasets need: intrinsics and world->camera extrinsics.

The port's numpy copies of bifold_tpu/ops/geometry.py:26
(``intrinsic_from_fov``), :38 (``rotation_matrix_4x4``) and :60
(``matrix_world_to_camera``). The array functions of that module (pixel
unprojection, point clouds) belong to the graph model families and are not
ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["intrinsic_from_fov", "rotation_matrix_4x4", "matrix_world_to_camera"]


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
