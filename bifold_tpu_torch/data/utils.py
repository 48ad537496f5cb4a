"""Host-side dataset helpers: the unimanual camera and its cloth mask.

The port's copy of ``DENG_CAMERA_PARAMS`` and ``get_mask_from_depth``
(bifold_tpu/data/utils.py:22, :32). The point-cloud graph helpers of that
module (voxelizing, farthest-point sampling, radius graphs over
``scipy.spatial.cKDTree``) serve the graph model families only and are not
ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DENG_CAMERA_PARAMS", "get_mask_from_depth"]

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
