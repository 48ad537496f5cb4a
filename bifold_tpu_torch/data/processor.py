"""Preprocessing: raw records -> model-ready samples, on device.

Counterpart of bifold_tpu/data/processor.py:62-230 and :233-387. The host
builds a fixed-schema raw record (:meth:`Processor.make_raw`: uint8 rgb,
float depth and mask, tokenized instruction, context frames padded to
``max_context_length``, labels padded to 8 points); :func:`_core` then runs
the image transforms as tensor operations on the device the inputs live on:
gray-77 composite with uint8 truncation, PIL-exact bicubic resize as two
matrix products, SigLIP or CLIP normalize, masked depth, rounded mask,
context padding and mask, label scaling.

The ``"train"`` partition adds, as the JAX package does: depth shift and
noise (off in the shipped config), joint spatial augmentation of ``rgb``,
``depth``, ``raw_rgb``, ``rgb_context`` and ``depth_context`` (and ``mask``
with ``augment_mask``) with the label pixels, and ``<label>_heatmap``
Gaussian targets. Its random draws (:meth:`Processor.draw`) come from the
``generator`` a call hands in: the data loader derives one per batch from
(seed, epoch, batch index), so a batch's augmentation does not depend on
which batches were built before it and a resumed epoch rebuilds its batches
exactly. A call without one draws from a ``torch.Generator`` per device
seeded by ``seed``, whose state a checkpoint keeps. :func:`_core` takes the
draws as an argument, so a caller can hand in any draws.

With ``requires_graph`` (graph-conditioned configs) the host also builds
the point-cloud graph of each sample (:meth:`Processor._graph_features`,
bifold_tpu/data/processor.py:427-491): the depth map and mask resized to
the model's size, back-projected through the camera, voxelized,
farthest-point sampled to ``num_nodes`` and centred, radius edges, all
padded to fixed shapes (``graph_x``, ``graph_node_mask``,
``graph_edge_index``, ``graph_edge_attr``, ``graph_edge_mask``, up to 16
edges per node), the pick labels' ``<label>_node_heatmap`` and, in the
test partition, the nodes' pixels ``pixel_sampled_pc``. These keys pass
through the device pipeline unchanged. An empty cloth mask raises a
``ValueError`` naming it (JAX's fails on it too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bifold_tpu_torch.data.tokenizers import build_tokenizer
from bifold_tpu_torch.data.utils import compute_edge_attr, fps, voxelize_pointcloud
from bifold_tpu_torch.ops import depth as depth_ops
from bifold_tpu_torch.ops import image as image_ops
from bifold_tpu_torch.ops.augment import spatial_augment
from bifold_tpu_torch.ops.gaussmap import batched_gaussmap
from bifold_tpu_torch.ops.geometry import (pixel_from_world, world_coords_from_depth,
                                           world_from_pixel)

__all__ = ["Processor", "MAX_LABEL_POINTS"]

MAX_LABEL_POINTS = 8
_DUMMY = -np.ones((MAX_LABEL_POINTS, 2), dtype=np.float32)


def pad_label(val: Optional[np.ndarray]) -> np.ndarray:
    """(2,) or (k, 2) label -> fixed (8, 2) float32 padded with -1."""
    out = _DUMMY.copy()
    if val is not None:
        val = np.asarray(val, np.float32).reshape(-1, 2)[:MAX_LABEL_POINTS]
        out[: len(val)] = val
    return out


@dataclasses.dataclass(frozen=True)
class _CoreSpec:
    """Static configuration of one :func:`_core` call."""

    image_size: int
    sigma: float
    strategy: str
    mask_depth: bool
    standardize_depth: bool
    random_depth_shift: bool
    add_depth_noise: bool
    min_shift: float
    max_shift: float
    spatial_augment: bool
    max_trials: int
    rotate_range: tuple
    translate_range: tuple
    image_mean: tuple
    image_std: tuple
    siglip_norm: bool
    augment_mask: bool
    train: bool
    label_keys: tuple
    has_rgb: bool
    has_depth: bool
    has_mask: bool
    n_context: int
    context_rgb: bool


def _resize(x, size):
    return image_ops.resize(x, size, method="bicubic", antialias=True)


def _process_rgb(spec: _CoreSpec, rgb_u8, mask):
    """uint8 (B, H, W, 3) + optional (B, H, W) mask -> normalized (B, 3, S, S)."""
    rgb = rgb_u8.permute(0, 3, 1, 2)
    if mask is not None:
        rgb = image_ops.composite_background(rgb, mask)
    resized = _resize(rgb.float(), spec.image_size)
    mean = image_ops.SIGLIP_MEAN if spec.siglip_norm else spec.image_mean
    std = image_ops.SIGLIP_STD if spec.siglip_norm else spec.image_std
    return image_ops.normalize(resized, mean, std)


def _process_depth(spec: _CoreSpec, depth, mask, shift=None, noise=None):
    """(B, H, W) depth (+mask) -> (B, 1, S, S) f32 in the reference's order:
    [shift] [noise] -> mask-multiply -> resize -> [standardize]. ``shift``
    (B, 1, 1) and ``noise`` (3, B, H, W) standard normals (y, x, disparity)
    are the train partition's draws."""
    depth = depth.float()
    if shift is not None:
        depth = depth_ops.depth_shift(depth, shift)
    if noise is not None:
        depth = depth_ops.depth_noise(depth, noise[0], noise[1], noise[2])
    if spec.mask_depth and mask is not None:
        depth = depth_ops.mask_depth(depth, mask)
    out = _resize(depth, spec.image_size)[:, None]
    if spec.standardize_depth:
        out = depth_ops.truncated_standardization(out)
    return out


def _core(spec: _CoreSpec, rgb, depth, mask, ctx_rgb, ctx_depth, ctx_mask,
          ctx_count, labels, draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The pipeline on device tensors at the input resolution; ``labels``
    maps label name -> (B, 8, 2) pixels (-1 padded). ``draws``: the train
    partition's random numbers (:meth:`Processor.draw`), keys
    ``depth_shift`` / ``ctx_depth_shift`` (B or B*T, 1, 1),
    ``depth_noise`` / ``ctx_depth_noise`` (3, B or B*T, H, W) and
    ``angles``, ``dxs``, ``dys`` (B, max_trials); each is used only when
    ``spec`` turns its transform on."""
    s = spec.image_size
    draws = draws or {}
    out: Dict[str, Any] = {}
    first = next(x for x in (rgb, depth, mask) if x is not None)
    batch, in_size = first.shape[0], first.shape[1]

    if depth is not None:
        out["depth"] = _process_depth(spec, depth, mask, draws.get("depth_shift"),
                                      draws.get("depth_noise"))
    if mask is not None:
        out["mask"] = depth_ops.round_mask(_resize(mask.float(), s))[:, None]
    if rgb is not None:
        out["rgb"] = _process_rgb(spec, rgb, mask)
        # resized-only copy, kept float until after augmentation
        out["raw_rgb"] = _resize(rgb.permute(0, 3, 1, 2).float(), s)

    if spec.n_context:
        t = spec.n_context
        in_frame = torch.arange(t, device=ctx_count.device)[None, :] < ctx_count[:, None]
        out["context_attention_mask"] = in_frame.to(torch.int32)
        flat_mask = (ctx_mask.reshape(batch * t, *ctx_mask.shape[2:])
                     if ctx_mask is not None else None)
        cd = _process_depth(spec, ctx_depth.reshape(batch * t, *ctx_depth.shape[2:]),
                            flat_mask, draws.get("ctx_depth_shift"),
                            draws.get("ctx_depth_noise")).reshape(batch, t, 1, s, s)
        sel = in_frame[:, :, None, None, None]
        # padding frames are all-ones tensors
        out["depth_context"] = torch.where(sel, cd, torch.ones_like(cd))
        if spec.context_rgb and ctx_rgb is not None:
            cr = _process_rgb(spec, ctx_rgb.reshape(batch * t, *ctx_rgb.shape[2:]),
                              flat_mask).reshape(batch, t, 3, s, s)
            out["rgb_context"] = torch.where(sel, cr, torch.ones_like(cr))

    scale = in_size / s   # labels: input -> model resolution
    scaled = {}
    for k in spec.label_keys:
        lab = labels[k].float()
        valid = lab.amin(dim=-1) >= 0
        scaled[k] = torch.where(valid[..., None], lab / scale, lab)

    if spec.train and spec.spatial_augment and spec.label_keys:
        allpix = torch.cat([scaled[k] for k in spec.label_keys], dim=1)
        warp = [k for k in ("rgb", "depth", "raw_rgb", "rgb_context",
                            "depth_context") if k in out]
        if spec.augment_mask and "mask" in out:
            warp.append("mask")
        images, allpix, _ = spatial_augment(
            {k: out[k] for k in warp}, allpix, allpix.amin(dim=-1) >= 0,
            draws["angles"], draws["dxs"], draws["dys"], image_size=s)
        out.update(images)
        for i, k in enumerate(spec.label_keys):
            scaled[k] = allpix[:, i * MAX_LABEL_POINTS: (i + 1) * MAX_LABEL_POINTS]

    for k in spec.label_keys:
        out[k] = scaled[k]
        if spec.train:
            out[f"{k}_heatmap"] = batched_gaussmap(
                scaled[k], scaled[k].amin(dim=-1) >= 0, size=s,
                sigma=spec.sigma, strategy=spec.strategy)
    if "raw_rgb" in out:
        out["raw_rgb"] = (out["raw_rgb"].round().clamp(0, 255)
                          .permute(0, 2, 3, 1).to(torch.uint8))
    return out


class Processor:
    """Train- and test-partition preprocessing. ``cfg`` is the ``processor``
    config node; ``autoprocessor_name`` selects SigLIP normalization and the
    SigLIP tokenizer (``spm_asset``: a ``spiece.model`` path or bytes), its
    absence the config's ``image_mean`` / ``image_std`` and the tokenizer of
    ``cfg["text_encoder"]`` (CLIP's BPE for a CLIP model name);
    ``seed`` seeds the train partition's draws of calls without a generator.
    ``cfg["requires_graph"]`` adds the graph features, built with
    ``num_nodes``, ``neighbor_radius`` and ``voxel_size`` (the dataset
    config's), which it then needs."""

    def __init__(self, cfg, partition: str = "test",
                 max_context_length: Optional[int] = None,
                 autoprocessor_name: Optional[str] = None, spm_asset=None,
                 seed: int = 0, num_nodes: Optional[int] = None,
                 neighbor_radius: Optional[float] = None,
                 voxel_size: Optional[float] = None):
        if partition not in ("train", "test"):
            raise NotImplementedError(f"partition {partition!r}: the Processor "
                                      "has a train and a test partition")
        cfg = dict(cfg)
        self.cfg = cfg
        self.requires_graph = bool(cfg.get("requires_graph", False))
        if self.requires_graph and None in (num_nodes, neighbor_radius, voxel_size):
            raise ValueError(
                "requires_graph needs num_nodes, neighbor_radius and voxel_size "
                "(the dataset config's), got "
                f"{num_nodes!r}, {neighbor_radius!r}, {voxel_size!r}")
        self.num_nodes = num_nodes
        self.neighbor_radius = neighbor_radius
        self.voxel_size = voxel_size
        self.partition = partition
        self.image_size = int(cfg["model_image_size"])
        self.max_context_length = max_context_length or 0
        self.process_context = max_context_length is not None
        self.autoprocessor_name = autoprocessor_name
        self.spm_asset = spm_asset
        self.tokenize = build_tokenizer(autoprocessor_name, spm_asset=spm_asset,
                                        text_encoder=cfg.get("text_encoder"))
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}
        sa = dict(cfg.get("spatial_augmentations", {}))
        da = dict(cfg.get("depth_augmentations", {}))
        self._spec_base = dict(
            image_size=self.image_size,
            sigma=float(cfg.get("sigma", 5.0)),
            strategy=str(cfg.get("strategy", "gmm")),
            mask_depth=bool(cfg.get("mask_depth", True)),
            standardize_depth=bool(cfg.get("standardize_depth", False)),
            random_depth_shift=bool(da.get("random_depth_shift", False)),
            add_depth_noise=bool(da.get("add_depth_noise", False)),
            min_shift=float(da.get("min_shift", -0.2)),
            max_shift=float(da.get("max_shift", 0.2)),
            spatial_augment=bool(cfg.get("spatial_augment", True)),
            max_trials=int(sa.get("max_augmentation_trials", 5)),
            rotate_range=tuple(sa.get("rotate_augmentation", (-5.0, 6.0))),
            translate_range=tuple(sa.get("translate_augmentation", (-5.0, 6.0))),
            image_mean=tuple(cfg.get("image_mean", image_ops.CLIP_MEAN)),
            image_std=tuple(cfg.get("image_std", image_ops.CLIP_STD)),
            siglip_norm=autoprocessor_name is not None,
            augment_mask=bool(cfg.get("augment_mask", False)),
            train=partition == "train",
        )

    def make_raw(self, rgb=None, depth=None, mask=None, instruction=None,
                 matrix_world_to_camera=None, K=None, context=None,
                 **labels) -> Dict[str, Any]:
        """Fixed-schema raw record (host side), the same arrays as the JAX
        package's ``make_raw``. ``context`` is a list of dicts with
        depth/rgb/mask keys (latest last), truncated to
        ``max_context_length``; ``labels`` are pick/place pixel arrays."""
        raw: Dict[str, Any] = {}
        if rgb is not None:
            raw["rgb"] = np.asarray(rgb, np.uint8)
        if depth is not None:
            raw["depth"] = np.asarray(depth, np.float32)
        if mask is not None:
            raw["mask"] = np.asarray(mask, np.float32)
        if instruction is not None:
            raw["raw_instruction"] = instruction
            raw["instruction"] = self.tokenize(instruction)
        if matrix_world_to_camera is not None:
            raw["matrix_world_to_camera"] = np.asarray(matrix_world_to_camera, np.float32)
        if K is not None:
            raw["K"] = np.asarray(K, np.float32)
        if self.process_context:
            t = self.max_context_length
            frames = list(context or [])[-t:]
            raw["ctx_count"] = np.int32(len(frames))
            if depth is not None:
                h, w = raw["depth"].shape
            else:
                h = w = self.image_size
            raw["ctx_depth"] = np.ones((t, h, w), np.float32)
            raw["ctx_mask"] = np.ones((t, h, w), np.float32)
            if rgb is not None:
                raw["ctx_rgb"] = np.ones((t, h, w, 3), np.uint8)
            for i, item in enumerate(frames):
                raw["ctx_depth"][i] = item["depth"]
                if item.get("mask") is not None:
                    raw["ctx_mask"][i] = item["mask"]
                if rgb is not None and "rgb" in item:
                    raw["ctx_rgb"][i] = item["rgb"]
        label_keys = sorted(k for k in labels if "pick" in k or "place" in k)
        raw["label_keys"] = tuple(label_keys)
        for k in label_keys:
            raw[k] = pad_label(labels[k])
        return raw

    def __call__(self, rgb=None, depth=None, mask=None, instruction=None,
                 matrix_world_to_camera=None, K=None, context=None,
                 **labels) -> Dict[str, Any]:
        """Process one sample on the host (the CPU): numpy arrays without a
        batch dim for the per-sample keys, as the JAX package's per-item
        Processor call returns them (bifold_tpu/data/processor.py:393)."""
        raw = self.make_raw(rgb=rgb, depth=depth, mask=mask, instruction=instruction,
                            matrix_world_to_camera=matrix_world_to_camera, K=K,
                            context=context, **labels)
        if self.requires_graph:
            raw.update(self._graph_features(raw))
        batch: Dict[str, Any] = {}
        for k, v in raw.items():
            if isinstance(v, np.ndarray):
                batch[k] = v[None]
            elif k == "label_keys":
                batch[k] = v
            elif isinstance(v, (np.integer, int)):
                batch[k] = np.asarray([v])
            else:
                batch[k] = [v]
        sample: Dict[str, Any] = {}
        for k, v in self.process_batch(batch, "cpu").items():
            if isinstance(v, torch.Tensor) and v.ndim > 0:
                sample[k] = v[0].numpy()
            elif isinstance(v, list) and len(v) == 1:
                sample[k] = v[0]
            else:
                sample[k] = v
        return sample

    def _spec(self, batch: Dict[str, Any]) -> _CoreSpec:
        return _CoreSpec(
            label_keys=tuple(batch.get("label_keys", ())),
            has_rgb="rgb" in batch,
            has_depth="depth" in batch,
            has_mask="mask" in batch,
            n_context=self.max_context_length if "ctx_depth" in batch else 0,
            context_rgb="ctx_rgb" in batch,
            **self._spec_base,
        )

    def _generator(self, device: torch.device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device).manual_seed(self.seed)
        return self._generators[device]

    def draw(self, spec: _CoreSpec, batch: int, in_shape, device,
             generator: Optional[torch.Generator] = None,
             rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
        """The train partition's random numbers for one batch of ``batch``
        samples at input resolution ``in_shape`` (H, W), from ``generator``
        (a generator on ``device``) or else this processor's generator on
        ``device``: uniform depth shifts, standard normals for depth noise,
        and ``max_trials`` uniform (angle, dx, dy) augmentation trials per
        sample. ``rows=(start, total)``: the batch is samples ``start`` to
        ``start + batch`` of a global batch of ``total`` (one rank's slice
        under data parallelism); the draws are the global batch's, cut to
        those samples."""
        if not spec.train:
            return {}
        if rows is not None and rows != (0, batch):
            start, total = rows
            draws = self.draw(spec, total, in_shape, device, generator)
            t = max(spec.n_context, 1)
            # (sample axis, rows per sample) of each draw; contexts are
            # flattened sample-major
            axes = {"depth_shift": (0, 1), "ctx_depth_shift": (0, t),
                    "depth_noise": (1, 1), "ctx_depth_noise": (1, t)}
            for k, v in draws.items():
                axis, per = axes.get(k, (0, 1))
                draws[k] = v.narrow(axis, start * per, batch * per)
            return draws
        gen = generator if generator is not None else self._generator(device)
        t = spec.n_context

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=gen, device=device)
            return u * (hi - lo) + lo

        draws: Dict[str, Any] = {}
        for prefix, n in (("", batch), ("ctx_", batch * t)):
            if n == 0 or (prefix and not t):
                continue
            if spec.random_depth_shift:
                draws[prefix + "depth_shift"] = uniform((n, 1, 1), spec.min_shift,
                                                        spec.max_shift)
            if spec.add_depth_noise:
                draws[prefix + "depth_noise"] = torch.randn(
                    (3, n, *in_shape), generator=gen, device=device)
        if spec.spatial_augment and spec.label_keys:
            shape = (batch, spec.max_trials)
            draws["angles"] = uniform(shape, *spec.rotate_range)
            draws["dxs"] = uniform(shape, *spec.translate_range)
            draws["dys"] = uniform(shape, *spec.translate_range)
        return draws

    def generator_states(self) -> Dict[str, torch.Tensor]:
        """``get_state()`` of each device's generator of calls without a
        generator, keyed by device name (a checkpoint keeps them)."""
        return {str(d): g.get_state() for d, g in self._generators.items()}

    def set_generator_states(self, states: Dict[str, torch.Tensor]) -> None:
        for name, state in states.items():
            self._generator(torch.device(name)).set_state(torch.as_tensor(state))

    def process_batch(self, batch: Dict[str, Any], device,
                      draws: Optional[Dict[str, Any]] = None,
                      generator: Optional[torch.Generator] = None,
                      rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
        """A collated raw batch (numpy, leading dim B, as :meth:`make_raw`
        records stack) -> the sample dict on ``device``. The train partition
        draws its random numbers here, from ``generator`` when given (for
        the samples ``rows`` names, :meth:`draw`), unless ``draws`` are
        given."""
        device = torch.device(device)
        x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch.items() if isinstance(v, np.ndarray)}
        return self.process_tensors(batch, x, draws=draws, generator=generator, rows=rows)

    def process_tensors(self, batch: Dict[str, Any], x: Dict[str, torch.Tensor],
                        draws: Optional[Dict[str, Any]] = None,
                        generator: Optional[torch.Generator] = None,
                        rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
        """:meth:`process_batch` on ``x``, the batch's arrays already on
        their device as tensors; the other keys come from ``batch``
        (``label_keys``, ``raw_instruction``)."""
        spec = self._spec(batch)
        first = next(x[k] for k in ("rgb", "depth", "mask") if k in x)
        if draws is None:
            draws = self.draw(spec, first.shape[0], tuple(first.shape[1:3]),
                              first.device, generator, rows)
        out = _core(spec, x.get("rgb"), x.get("depth"), x.get("mask"),
                    x.get("ctx_rgb"), x.get("ctx_depth"), x.get("ctx_mask"),
                    x.get("ctx_count"), {k: x[k] for k in spec.label_keys}, draws)
        if "instruction" in x:
            out["instruction"] = x["instruction"]
        if "raw_instruction" in batch:
            out["raw_instruction"] = batch["raw_instruction"]
        for k in x:          # the graph features pass through
            if k.startswith("graph") or k == "pixel_sampled_pc" or k.endswith("_node_heatmap"):
                out[k] = x[k]
        return out

    def _graph_features(self, raw: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """The graph arrays of one raw record (host side, numpy out; module
        docstring). Needs the record's ``K`` and ``matrix_world_to_camera``."""
        if "K" not in raw or "matrix_world_to_camera" not in raw:
            raise ValueError("graph features need the camera: pass K= and "
                             "matrix_world_to_camera= with the observation")
        s = self.image_size
        depth = raw["depth"]
        scale = depth.shape[0] / s
        scaled_k = raw["K"].copy()
        scaled_k[0, :] /= scale
        scaled_k[1, :] /= scale
        with torch.no_grad():
            depth_ori = _resize(torch.from_numpy(depth)[None], s)[0]
            mask_ori = depth_ops.round_mask(
                _resize(torch.from_numpy(raw["mask"])[None], s))[0].numpy()
        m_w2c = raw["matrix_world_to_camera"]

        world = world_coords_from_depth(depth_ori, m_w2c, scaled_k).numpy()
        pc = world[..., :3].reshape(-1, 3)[mask_ori.reshape(-1) > 0].astype(np.float32)
        if not len(pc):
            raise ValueError("graph features need cloth: the observation's cloth "
                             "mask is empty")
        sampled = fps(voxelize_pointcloud(pc, self.voxel_size),
                      self.num_nodes).astype(np.float32)
        centered = sampled - sampled.mean(axis=0)
        edges, edge_attr = compute_edge_attr(centered, self.neighbor_radius)

        n = self.num_nodes
        e_max = n * 16
        x = np.zeros((n, 3), np.float32)
        x[: len(centered)] = centered
        node_mask = np.zeros((n,), np.float32)
        node_mask[: len(centered)] = 1.0
        ei = np.zeros((2, e_max), np.int64)
        ea = np.zeros((e_max, 4), np.float32)
        em = np.zeros((e_max,), np.float32)
        ne = min(edges.shape[1], e_max)
        ei[:, :ne] = edges[:, :ne]
        ea[:ne] = edge_attr[:ne]
        em[:ne] = 1.0
        out = {"graph_x": x, "graph_node_mask": node_mask, "graph_edge_index": ei,
               "graph_edge_attr": ea, "graph_edge_mask": em}

        for k in raw.get("label_keys", ()):      # pick node targets
            if "pick" not in k:
                continue
            pix = raw[k]
            valid = pix.min(axis=-1) >= 0
            heat = np.zeros((n,), np.float32)
            if valid.any():
                pos = world_from_pixel(pix[valid][0] / scale, depth_ori, m_w2c,
                                       scaled_k).numpy()
                d = ((sampled - pos) ** 2).sum(axis=1)
                heat[: len(sampled)] = (d == d.min()).astype(np.float32)
            out[f"{k}_node_heatmap"] = heat

        if self.partition == "test":
            pix = pixel_from_world(sampled, m_w2c, scaled_k).numpy()
            padded = np.zeros((2, n), np.float32)
            padded[:, : pix.shape[1]] = pix
            out["pixel_sampled_pc"] = padded.T
        return out
