"""Real-world test dataset: cropped RGB/mask/raw-depth captures + GT pixels.

The port's copy of bifold_tpu/data/real_dataset.py (``get_instructions``
:27, ``RealDataset`` :57): walks category directories of cropped captures
(multiple depth exposures median-filtered), enumerates instruction
paraphrase sets from the folding templates per category/step, and builds
symmetric label sets from the annotation npy so left/right symmetry isn't
penalized — each arm's pick set contains both arms' picks AND both places.
Fixed pinhole intrinsics fx/fy ~ 605.7, identity extrinsics. Test partition
only. Pillow is imported by this module only (see
:mod:`bifold_tpu_torch.data.bimanual_dataset`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image

from bifold_tpu_torch.data.datasets import BaseDataset
from bifold_tpu_torch.data.templates import folding_actions

__all__ = ["RealDataset", "get_instructions"]


def get_instructions(category: str, instruction_idx: int) -> List[str]:
    """All paraphrases describing step ``instruction_idx`` of folding
    ``category`` (reference real_dataset.py:160-212)."""
    if category == "long_shirt":
        if instruction_idx == 0:
            return [t.format(which="left") for t in folding_actions["sleeves"]]
        if instruction_idx == 1:
            return [t.format(which="right") for t in folding_actions["sleeves"]]
        if instruction_idx == 2:
            return [t.format(garment="tshirt", which1="top", which2="bottom")
                    for t in folding_actions["fold"]]
        raise ValueError(f"Instruction {instruction_idx} for {category} not supported")
    garments = {
        "short_shirt": ["tshirt"],
        "dress": ["dress", "skirt", "top"],
        "pants": ["trousers"],
        "towel": ["towel", "cloth", "tshirt", "trousers", "pants", "top", "skirt"],
    }.get(category)
    if garments is None:
        raise ValueError(f"Category {category} not supported")
    which = {0: ("left", "right"), 1: ("top", "bottom")}.get(instruction_idx)
    if which is None:
        raise ValueError(f"Instruction {instruction_idx} for {category} not supported")
    out = []
    for garment in garments:
        out.extend(t.format(garment=garment, which1=which[0], which2=which[1])
                   for t in folding_actions["fold"])
    return out


class RealDataset(BaseDataset):
    fx = 605.70623779
    fy = 605.82971191

    def __init__(self, cfg, *args, **kwargs):
        self.max_context_length = cfg["max_context_length"]
        super().__init__(cfg, *args, **kwargs,
                         max_context_length=self.max_context_length)
        assert self.partition == "test", \
            "This dataset cannot be used for other than testing"

        self.depths: List[np.ndarray] = []
        self.rgbs: List[np.ndarray] = []
        self.masks: List[np.ndarray] = []
        self.instructions: List[str] = []
        self.contexts: List[List[Dict]] = []
        self.ground_truth: List = []

        for category in sorted(os.listdir(self.dataset_path)):
            if category == "empty":
                continue
            depth_dir = os.path.join(self.dataset_path, category, "cropped_raw_depth")
            groups: Dict[str, List[str]] = {}
            for np_file in sorted(os.listdir(depth_dir)):
                prefix = "_".join(os.path.splitext(np_file)[0].split("_")[:-1])
                groups.setdefault(prefix, []).append(np_file)

            for prefix, np_files in groups.items():
                _cloth_id, *cat_parts, instruction_idx = prefix.split("_")
                cat = "_".join(cat_parts)
                try:
                    instructions = get_instructions(cat, int(instruction_idx))
                except ValueError:
                    continue  # no action defined for this step
                self.instructions.extend(instructions)
                for _ in instructions:
                    self._append_capture(category, np_files, int(instruction_idx))

        self.K = np.eye(4)
        self.K[0, 0] = self.fx
        self.K[1, 1] = self.fy
        self.K[0, 2] = self.depths[0].shape[0] / 2
        self.K[1, 2] = self.depths[0].shape[1] / 2
        self.matrix_world_to_camera = np.eye(4)
        assert len(self.depths) == len(self.rgbs) == len(self.instructions)

    # ------------------------------------------------------------------

    def _load_frame(self, category: str, np_file: str) -> Dict:
        base = os.path.join(self.dataset_path, category)
        depth = np.load(os.path.join(base, "cropped_raw_depth", np_file)) / self.depth_scale
        rgb = np.array(Image.open(os.path.join(
            base, "cropped_rgb", np_file.replace(".npy", ".png"))))
        mask = np.array(Image.open(os.path.join(
            base, "cropped_mask", np_file.replace(".npy", ".png"))))[:, :, 0] / 255
        return {"depth": depth.astype(np.float32), "rgb": rgb,
                "mask": mask.astype(np.float32)}

    def _append_capture(self, category: str, np_files: List[str],
                        instruction_idx: int) -> None:
        base = os.path.join(self.dataset_path, category)
        # median over repeated exposures de-noises the raw depth (:50-65)
        depth = np.median(
            [np.load(os.path.join(base, "cropped_raw_depth", f)) for f in np_files],
            axis=0) / self.depth_scale
        self.depths.append(depth.astype(np.float32))
        first = self._load_frame(category, np_files[0])
        self.rgbs.append(first["rgb"])
        self.masks.append(first["mask"])

        head = "_".join(np_files[0].split("_")[:-1])
        gt_file = os.path.join(base, "cropped_annotations", head + ".npy")
        if os.path.isfile(gt_file):
            gt = np.load(gt_file)
            self.ground_truth.append(gt[None] if gt.ndim == 1 else gt)
        else:
            self.ground_truth.append(None)

        context = []
        for ctx_idx in range(instruction_idx):
            *h, _, tail = np_files[0].split("_")
            ctx_file = "_".join([*h, str(ctx_idx), tail])
            try:
                context.append(self._load_frame(category, ctx_file))
            except FileNotFoundError:
                pass
        self.contexts.append(context)

    def __len__(self) -> int:
        return len(self.depths)

    def __getitem__(self, index: int) -> Dict:
        labels = {}
        gt = self.ground_truth[index]
        if gt is not None:
            left_pick = gt[:, [0, 1]]
            left_place = gt[:, [2, 3]]
            right_pick = gt[:, [4, 5]]
            right_place = gt[:, [6, 7]]
            # symmetric credit (reference :219-229)
            labels["left_pick"] = np.r_[left_pick, right_pick, left_place, right_place]
            labels["left_place"] = np.r_[left_place, right_place, left_pick, right_pick]
            labels["right_pick"] = np.r_[right_pick, left_pick, right_place, left_place]
            labels["right_place"] = np.r_[right_place, left_place, right_pick, left_pick]
        else:
            labels = {k: None for k in ("left_pick", "left_place",
                                        "right_pick", "right_place")}
        return self._finalize(self.processor.make_raw(
            rgb=self.rgbs[index], depth=self.depths[index],
            mask=self.masks[index], instruction=self.instructions[index],
            context=self.contexts[index], K=self.K,
            matrix_world_to_camera=self.matrix_world_to_camera, **labels))
