"""Bimanual vr-folding datasets: zarr meshes + action CSVs + rendered views.

The port's copy of bifold_tpu/data/bimanual_dataset.py (``BimanualDataset``
:170, ``BimanualDatasetSequential`` :177 and their base :49). Actions CSVs
carry per-arm grip vertex-id lists and start/end frame names; labels are
those vertices projected through the per-view camera matrix with the
renderer's x-flip; the mask is depth != depth.max(); sequential variants
add per-action context frame lists whose images are loaded from the
renders. Records equal the JAX package's byte for byte.

pandas and Pillow are imported by this module only; the dataset registry
(:mod:`bifold_tpu_torch.data`) reaches it through a factory, so a host
without them still trains on the synthetic dataset. Zarr access goes
through :mod:`bifold_tpu_torch.data.zarr_lite` (the real `zarr` package when
installed, else the built-in v2 reader).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
from PIL import Image

from bifold_tpu_torch.data.datasets import BaseDataset
from bifold_tpu_torch.data.zarr_lite import open_group

__all__ = ["BimanualDataset", "BimanualDatasetSequential",
           "get_mask_from_depth_bimanual", "parse_list_string"]


def parse_list_string(s):
    """CSV cell -> python list, safely (reference uses ast.literal_eval,
    data/utils.py:26-32)."""
    try:
        return ast.literal_eval(s)
    except (SyntaxError, ValueError):
        return None


def get_mask_from_depth_bimanual(depth: np.ndarray) -> np.ndarray:
    """Bimanual renders: background = the max depth value
    (reference bimanual_dataset.py:12-16)."""
    mask = np.ones_like(depth, dtype=np.float32)
    mask[depth == depth.max()] = 0
    return mask


class _BimanualBase(BaseDataset):
    actions_subdir = "actions"

    def __init__(self, cfg, *args, max_context_length=None, **kwargs):
        super().__init__(cfg, *args, **kwargs,
                         max_context_length=max_context_length)
        self.max_context_length = max_context_length or 0
        zarr_path = os.path.join(self.dataset_path, "vr_folding_dataset.zarr")
        categories = [c for c in os.listdir(zarr_path)
                      if os.path.isdir(os.path.join(zarr_path, c))]
        self.zarr_datasets = {c: open_group(os.path.join(zarr_path, c))
                              for c in categories}
        converters = {col: parse_list_string for col in
                      ("left_grip_from", "left_grip_to",
                       "right_grip_from", "right_grip_to")}
        self.actions_df = pd.read_csv(
            os.path.join(self.dataset_path, self.actions_subdir,
                         self.partition + ".csv"),
            converters=converters, index_col=0)
        self.renders_path = os.path.join(self.dataset_path, "renders")
        self.image_size = int(self.cfg["image_size"])

    def __len__(self) -> int:
        return len(self.actions_df)

    # ------------------------------------------------------------------

    @staticmethod
    def _frame_of(action, start: bool):
        """Start (or end) frame: the arm that starts earlier wins the start
        frame; the later end wins the end frame (bimanual_dataset.py:52-97)."""
        lkey, rkey = (("left_start_idx", "right_start_idx") if start
                      else ("left_end_idx", "right_end_idx"))
        lval, rval = action[lkey], action[rkey]
        l_idx = int(str(lval).split("_")[-1]) if isinstance(lval, str) else None
        r_idx = int(str(rval).split("_")[-1]) if isinstance(rval, str) else None
        if l_idx is None:
            return rval
        if r_idx is None:
            return lval
        if start:
            return lval if l_idx <= r_idx else rval
        return rval if l_idx <= r_idx else lval

    @classmethod
    def get_info_from_action(cls, action):
        frame = cls._frame_of(action, start=True)
        category = frame.split("_")[1]
        camera_file = "_".join(frame.split("_")[:-1]) + ".npy"
        return frame, category, camera_file

    @classmethod
    def get_last_frame_from_action(cls, action):
        return cls._frame_of(action, start=False)

    # ------------------------------------------------------------------

    def project(self, category: str, frame: str, vertices: Optional[List[int]],
                camera_matrix: np.ndarray) -> Optional[np.ndarray]:
        """Grip vertex ids -> pixel coordinates through the full camera matrix
        (intr @ world_to_camera) with the renderer's horizontal flip
        (bimanual_dataset.py:102-115)."""
        if vertices is None:
            return None
        mesh = self.zarr_datasets[category]["samples"][frame]["mesh"]
        world = np.asarray(mesh["cloth_verts"])[np.asarray(vertices, int)]
        hom = np.column_stack([world, np.ones(len(world))])
        unnorm = (camera_matrix @ hom.T).T
        screen = unnorm[:, :2] / unnorm[:, -2:-1]
        screen[:, 0] = self.image_size - screen[:, 0]
        return screen

    def _load_view(self, category: str, frame: str):
        depth = np.array(Image.open(os.path.join(
            self.renders_path, category, "depth", frame + ".png"))
        ) / self.depth_scale
        rgb = np.array(Image.open(os.path.join(
            self.renders_path, category, "colors", frame + ".png")))
        return rgb, depth.astype(np.float32)

    def _labels(self, action, frame, category, camera_matrix) -> Dict:
        labels = {
            "left_pick": self.project(category, frame,
                                      action["left_grip_from"], camera_matrix),
            "right_pick": self.project(category, frame,
                                       action["right_grip_from"], camera_matrix),
            "left_place": self.project(category, action["left_end_idx"],
                                       action["left_grip_to"], camera_matrix),
            "right_place": self.project(category, action["right_end_idx"],
                                        action["right_grip_to"], camera_matrix),
        }
        for k, v in labels.items():
            assert v is None or np.logical_and(0 < v, v < self.image_size).all(), \
                f"Label {k} out of frame for {frame}"
        return labels

    def _camera(self, category: str, camera_file: str):
        k = np.load(os.path.join(self.renders_path, category, "intrinsics.npy"))
        camera_matrix = np.load(os.path.join(
            self.renders_path, category, "camera_matrix", camera_file))
        intr = np.eye(4)
        intr[:3, :3] = k
        matrix_world_to_camera = np.linalg.inv(intr) @ camera_matrix
        return k, camera_matrix, matrix_world_to_camera

    def _base_item(self, action, context=None) -> Dict:
        frame, category, camera_file = self.get_info_from_action(action)
        rgb, depth = self._load_view(category, frame)
        assert self.image_size == depth.shape[0]
        mask = get_mask_from_depth_bimanual(depth)
        k, camera_matrix, m_w2c = self._camera(category, camera_file)
        labels = self._labels(action, frame, category, camera_matrix)
        raw = self.processor.make_raw(
            rgb=rgb, depth=depth, mask=mask, instruction=action["text"],
            matrix_world_to_camera=m_w2c, K=k[:3, :3] if k.shape == (3, 3) else k,
            context=context, **labels)
        raw["frame_start"] = frame
        raw["frame_end"] = self.get_last_frame_from_action(action)
        return self._finalize(raw)


class BimanualDataset(_BimanualBase):
    """Single-frame bimanual actions (`actions/{train,test}.csv`)."""

    def __getitem__(self, index: int) -> Dict:
        return self._base_item(self.actions_df.iloc[index])


class BimanualDatasetSequential(_BimanualBase):
    """Sequential actions with temporal context frames
    (`sequential_actions/*.csv`, context column of frame-name lists)."""

    actions_subdir = "sequential_actions"

    def __init__(self, cfg, *args, **kwargs):
        super().__init__(cfg, *args,
                         max_context_length=cfg["max_context_length"], **kwargs)

    def __getitem__(self, index: int) -> Dict:
        action = self.actions_df.iloc[index]
        _, category, _ = self.get_info_from_action(action)
        ctx_frames = [f for f in (parse_list_string(action["context"]) or [])]
        context = []
        for frame_ctx in ctx_frames:
            rgb, depth = self._load_view(category, frame_ctx)
            context.append({"rgb": rgb, "depth": depth,
                            "mask": get_mask_from_depth_bimanual(depth)})
        raw = self._base_item(action, context=context)
        # "+"-joined context names, padded/truncated like the reference
        # (bimanual_dataset_sequential.py:223-231) — the bimanual evaluator
        # replays these frames' cached states.
        t = self.max_context_length
        names = ctx_frames[-t:] + [""] * (t - len(ctx_frames[-t:]))
        raw["context_names"] = "+".join(names).rstrip("+")
        return raw
