"""Host-side dataset helpers: the unimanual camera, its cloth mask and the
point-cloud graph of graph-conditioned models.

The port's copy of bifold_tpu/data/utils.py: ``DENG_CAMERA_PARAMS`` (:22),
``get_mask_from_depth`` (:32), ``voxelize_pointcloud`` (:40),
``fps`` (:53) and ``compute_edge_attr`` (:69), numpy and
``scipy.spatial.cKDTree`` with the JAX package's semantics: voxels keyed by
``np.unique`` over floored coordinates, sampling from point 0, and each
radius pair emitted in both directions in ``query_pairs``' order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DENG_CAMERA_PARAMS", "get_mask_from_depth", "voxelize_pointcloud", "fps",
           "compute_edge_attr"]

# Camera of the unimanual (Deng et al. language_deformable) sim data
# (reference data/utils.py:8-15).
DENG_CAMERA_PARAMS = {
    "default_camera": {
        "pos": np.array([-0.0, 0.65, 0.0]),
        "angle": np.array([0, -np.pi / 2.0, 0.0]),
        "width": 720,
        "height": 720,
    }
}


def get_mask_from_depth(depth: np.ndarray, threshold: float = 0.996) -> np.ndarray:
    """Cloth mask for the unimanual sim data: far pixels (> threshold, the
    background plane) and empty pixels (depth == 0) are background;
    everything else is cloth."""
    return ((depth <= threshold) & (depth != 0)).astype(np.float32)


def voxelize_pointcloud(pointcloud: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid downsample: the mean of the points in each occupied voxel
    (open3d ``voxel_down_sample``'s centroids), voxels in ``np.unique``'s
    order of their integer keys."""
    if len(pointcloud) == 0:
        return pointcloud
    keys = np.floor(pointcloud / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((len(counts), pointcloud.shape[1]), dtype=np.float64)
    np.add.at(sums, inverse.reshape(-1), pointcloud)
    return (sums / counts[:, None]).astype(pointcloud.dtype)


def fps(pts: np.ndarray, k: int) -> np.ndarray:
    """Farthest-point sampling of ``k`` points, from point 0; all points
    when there are at most ``k``."""
    if len(pts) <= k:
        return pts
    selected = np.zeros(k, dtype=np.int64)
    dists = np.full(len(pts), np.inf)
    farthest = 0
    for i in range(k):
        selected[i] = farthest
        d = np.linalg.norm(pts - pts[farthest], axis=1)
        dists = np.minimum(dists, d)
        farthest = int(np.argmax(dists))
    return pts[selected]


def compute_edge_attr(vox_pc: np.ndarray, neighbor_radius: float):
    """Radius-graph edges (2, E) int64 and their float32 (E, 4) attributes,
    the displacement sender -> receiver and its length: each pair within
    ``neighbor_radius`` once as (i, j), then all of them again as (j, i)."""
    from scipy.spatial import cKDTree

    undirected = np.array(list(cKDTree(vox_pc).query_pairs(neighbor_radius)),
                          dtype=np.int64)
    if len(undirected) == 0:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0, 4), dtype=np.float32)
    senders = np.concatenate([undirected[:, 0], undirected[:, 1]])
    receivers = np.concatenate([undirected[:, 1], undirected[:, 0]])
    disp = vox_pc[receivers] - vox_pc[senders]
    dist = np.linalg.norm(disp, axis=1, keepdims=True)
    return (np.stack([senders, receivers]),
            np.concatenate([disp, dist], axis=1).astype(np.float32))
