"""Small numpy metric helpers: the port's copy of bifold_tpu/metrics/utils.py."""

import numpy as np

__all__ = ["iou"]


def iou(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    """Binary mask IoU in percent."""
    a = np.asarray(mask_a) > 0.5
    b = np.asarray(mask_b) > 0.5
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 100.0
    return float(np.logical_and(a, b).sum() / union * 100.0)
