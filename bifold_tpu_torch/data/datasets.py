"""Dataset classes producing raw records for the device-side Processor.

The port's copy of bifold_tpu/data/datasets.py: ``deng_camera_matrices``
(:26), ``BaseDataset`` (:36), ``SingleDataset`` (:71),
``SingleDatasetSequential`` (:101) and ``SyntheticDataset`` (:154). Each
``__getitem__`` returns the raw record the JAX package's returns, byte for
byte (uint8 images, float32 depth and mask, -1-padded labels, tokenized
text, the camera matrices); the loader collates records and the Processor
transforms whole batches on the device.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np

from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.data.utils import DENG_CAMERA_PARAMS, get_mask_from_depth
from bifold_tpu_torch.ops.geometry import intrinsic_from_fov, matrix_world_to_camera

__all__ = ["BaseDataset", "SingleDataset", "SingleDatasetSequential",
           "SyntheticDataset", "deng_camera_matrices"]


def deng_camera_matrices():
    """(matrix_world_to_camera, K) of the unimanual sim camera
    (reference single_dataset.py:49-56)."""
    cam = DENG_CAMERA_PARAMS["default_camera"]
    m = matrix_world_to_camera(cam["pos"], cam["angle"])
    k = intrinsic_from_fov(height=cam["height"], width=cam["width"], fov=45)
    return m, k


class BaseDataset:
    """Owns a Processor configured for its partition
    (reference data/__init__.py:6-26)."""

    def __init__(self, cfg, processor_config, partition: str = "train",
                 autoprocessor_name: Optional[str] = None,
                 max_context_length: Optional[int] = None, seed: int = 0):
        assert partition in ("train", "test")
        self.partition = partition
        self.cfg = dict(cfg)
        self.dataset_path = self.cfg.get("dataset_path")
        self.depth_scale = self.cfg.get("depth_scale", 1)
        self.processor = Processor(
            cfg=processor_config,
            partition=partition,
            num_nodes=self.cfg.get("num_nodes"),
            neighbor_radius=self.cfg.get("neighbor_radius"),
            voxel_size=self.cfg.get("voxel_size"),
            max_context_length=max_context_length,
            autoprocessor_name=autoprocessor_name,
            seed=seed,
        )

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raise NotImplementedError

    def _finalize(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        if self.processor.requires_graph:
            raw.update(self.processor._graph_features(raw))
        return raw


class SingleDataset(BaseDataset):
    """Unimanual 100-demo pkl: parallel lists of rgbs/depth/pick/place/
    instruction with the fixed Deng camera (reference single_dataset.py)."""

    def __init__(self, cfg, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        with open(self.dataset_path, "rb") as f:
            data = pickle.load(f)
        self.rgbs = data["rgbs"]
        self.depths = data["depth"]
        self.pick_pixels = data["pick"]
        self.place_pixels = data["place"]
        self.instructions = data["instruction"]
        assert (len(self.rgbs) == len(self.depths) == len(self.pick_pixels)
                == len(self.place_pixels) == len(self.instructions))
        self.m_w2c, self.k = deng_camera_matrices()

    def __len__(self):
        return len(self.instructions)

    def __getitem__(self, index):
        depth = np.asarray(self.depths[index], np.float32) / self.depth_scale
        mask = get_mask_from_depth(depth)
        return self._finalize(self.processor.make_raw(
            rgb=self.rgbs[index], depth=depth, mask=mask,
            instruction=self.instructions[index],
            matrix_world_to_camera=self.m_w2c, K=self.k,
            pick=self.pick_pixels[index], place=self.place_pixels[index]))


class SingleDatasetSequential(BaseDataset):
    """Unimanual episode pkl flattened into per-step events, each carrying the
    full prior-frame context (reference single_dataset_sequential.py)."""

    def __init__(self, cfg, *args, **kwargs):
        self.max_context_length = cfg["max_context_length"]
        super().__init__(cfg, *args, **kwargs,
                         max_context_length=self.max_context_length)
        with open(self.dataset_path, "rb") as f:
            data = pickle.load(f)
        self.episodes = data["episodes"]
        self.event_data = []
        for num_episode, episode in enumerate(self.episodes):
            for num_event in range(len(episode["depth"])):
                self.event_data.append({
                    "episode": num_episode,
                    "index": num_event,
                    "context": list(range(num_event)),
                })
                assert num_event - 1 <= self.max_context_length
        self.m_w2c, _ = deng_camera_matrices()

    def __len__(self):
        return len(self.event_data)

    def __getitem__(self, event_index):
        ev = self.event_data[event_index]
        episode = self.episodes[ev["episode"]]
        depth = np.asarray(episode["depth"][ev["index"]], np.float32) / self.depth_scale
        context = []
        for idx in ev["context"]:
            d = np.asarray(episode["depth"][idx], np.float32) / self.depth_scale
            context.append({"rgb": episode["rgbs"][idx], "depth": d,
                            "mask": get_mask_from_depth(d)})
        return self._finalize(self.processor.make_raw(
            rgb=episode["rgbs"][ev["index"]], depth=depth,
            mask=get_mask_from_depth(depth),
            instruction=episode["instruction"][ev["index"]],
            matrix_world_to_camera=self.m_w2c,
            pick=episode["pick"][ev["index"]],
            place=episode["place"][ev["index"]],
            context=context))


_SYNTH_TEMPLATES = [
    "fold the {obj} from {a} to {b}",
    "grab the {a} corner and fold to the {b}",
    "fold the {obj} in half",
    "bring the {a} edge of the {obj} to the {b} edge",
]
_SYNTH_OBJECTS = ["towel", "shirt", "trousers", "napkin", "cloth"]
_SYNTH_SIDES = ["left", "right", "top", "bottom"]


class SyntheticDataset(BaseDataset):
    """Procedural cloth-like scenes for tests/benchmarks: a random convex
    quadrilateral cloth mask on a table plane, textured rgb, depth with the
    cloth slightly above the plane, labels inside the mask. Deterministic per
    (seed, index); honors is_bimanual/max_context_length from its config."""

    def __init__(self, cfg, *args, **kwargs):
        self.n_samples = int(cfg.get("n_samples", 64))
        self.is_bimanual = bool(cfg.get("is_bimanual", False))
        self.input_size = int(cfg.get("input_size", cfg.get("image_size", 224)))
        mcl = cfg.get("max_context_length", 0) or 0
        self.max_context_length = int(mcl)
        super().__init__(cfg, *args, **kwargs,
                         max_context_length=self.max_context_length or None)
        self.m_w2c, _ = deng_camera_matrices()
        self.k = intrinsic_from_fov(self.input_size, self.input_size, fov=45)
        self.base_seed = int(cfg.get("seed", 0))

    def __len__(self):
        return self.n_samples

    def _scene(self, rng, size):
        cy, cx = rng.uniform(0.3, 0.7, 2) * size
        ang = rng.uniform(0, 2 * np.pi, 4) + np.array([0, np.pi / 2, np.pi, 3 * np.pi / 2])
        rad = rng.uniform(0.15, 0.35, 4) * size
        ys, xs = np.mgrid[0:size, 0:size]
        mask = np.ones((size, size), bool)
        pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
        for i in range(4):
            p, q = pts[i], pts[(i + 1) % 4]
            mask &= ((q[0] - p[0]) * (ys - p[1]) - (q[1] - p[1]) * (xs - p[0])) >= 0
        mask = mask.astype(np.float32)
        base = rng.uniform(0.2, 0.8, 3)
        tex = (base[None, None] * 255 * (0.7 + 0.3 * rng.random((size, size, 1)))
               ).astype(np.uint8)
        rgb = (tex * mask[..., None] + 30 * (1 - mask[..., None])).astype(np.uint8)
        depth = (0.99 - 0.02 * mask + 0.002 * rng.random((size, size))).astype(np.float32)
        return rgb, depth, mask, pts

    def _points_inside(self, rng, mask, n):
        ys, xs = np.nonzero(mask > 0)
        if len(xs) == 0:
            return np.full((n, 2), mask.shape[0] // 2, np.float32)
        sel = rng.integers(0, len(xs), n)
        return np.stack([xs[sel], ys[sel]], axis=1).astype(np.float32)

    def __getitem__(self, index):
        rng = np.random.default_rng(self.base_seed * 100003 + index)
        size = self.input_size
        rgb, depth, mask, _ = self._scene(rng, size)
        tmpl = _SYNTH_TEMPLATES[int(rng.integers(len(_SYNTH_TEMPLATES)))]
        instruction = tmpl.format(obj=_SYNTH_OBJECTS[int(rng.integers(5))],
                                  a=_SYNTH_SIDES[int(rng.integers(4))],
                                  b=_SYNTH_SIDES[int(rng.integers(4))])
        labels: Dict[str, Any] = {}
        if self.is_bimanual:
            labels["left_pick"] = self._points_inside(rng, mask, 1)[0]
            labels["right_pick"] = self._points_inside(rng, mask, 1)[0]
            labels["left_place"] = self._points_inside(rng, mask, 1)[0]
            labels["right_place"] = self._points_inside(rng, mask, 1)[0]
        else:
            labels["pick"] = self._points_inside(rng, mask, 1)[0]
            labels["place"] = self._points_inside(rng, mask, 1)[0]

        context = None
        if self.max_context_length:
            n_ctx = int(rng.integers(0, self.max_context_length + 1))
            context = []
            for j in range(n_ctx):
                crng = np.random.default_rng(self.base_seed * 100003 + index * 7 + j + 1)
                crgb, cdepth, cmask, _ = self._scene(crng, size)
                context.append({"rgb": crgb, "depth": cdepth, "mask": cmask})

        return self._finalize(self.processor.make_raw(
            rgb=rgb, depth=depth, mask=mask, instruction=instruction,
            matrix_world_to_camera=self.m_w2c, K=self.k, context=context,
            **labels))
