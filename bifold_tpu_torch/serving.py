"""Batch-1 and pooled serving: camera frames + instruction -> pixel Action.

Counterpart of bifold_tpu/serving.py:69-102, 187-465 and 717-740. The
control loop's path: tokenization and record assembly on the host, one
upload per input tensor, then preprocessing (``data.processor._core``), the
forward and the heatmap decode on the device, and one fetch of the packed
pixel actions.

The wire keeps the JAX package's value semantics: rgb travels as uint8,
masks as k/255-quantized uint8 (binary masks exact, soft masks to 1/255),
depth as float32 or, with ``depth_wire_dtype="float16"``, float16.

    model = build_model(cfg, dtype=torch.bfloat16)
    server = ServingModel(model, state_dict, Processor(...), device="cuda")
    action = server.predict(rgb, depth, mask, "fold the left sleeve in")
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.models import decode_action, resolve_device
from bifold_tpu_torch.data.processor import Processor, _core

__all__ = ["ServingModel", "ServingPolicy"]

_BINARY_INPUTS = ("mask", "ctx_mask")
_DEPTH_INPUTS = ("depth", "ctx_depth")
_PRECAST_MIN_SIZE = 2 ** 16


def _stack_raws(raws):
    """Stack N make_raw records into one batched observation dict."""
    batched = {k: np.stack([np.asarray(r[k]) for r in raws])
               for k, v in raws[0].items() if isinstance(v, np.ndarray)}
    if "ctx_count" in raws[0]:
        batched["ctx_count"] = np.asarray([r["ctx_count"] for r in raws])
    return batched


def _wire(name: str, arr: np.ndarray, depth_f16: bool) -> np.ndarray:
    """The host-side wire encoding of one raw input."""
    if name in _BINARY_INPUTS:
        return np.clip(np.round(arr.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)
    if name in ("rgb", "ctx_rgb"):
        return arr.astype(np.uint8)
    if name in ("instruction", "ctx_count"):
        return arr.astype(np.int32)
    if depth_f16 and name in _DEPTH_INPUTS:
        return arr.astype(np.float16)
    return arr.astype(np.float32)


class ServingModel:
    """Serve a copy of ``model`` (its weights replaced by ``state_dict`` when
    given) on ``device``, in eval mode. Big float32 weights (>= 2**16
    elements) are cast to the model's compute dtype once, as the JAX server
    does; small ones (biases, LayerNorm) stay float32. The copy leaves the
    caller's module as it was (a model can be served mid-training without
    rounding its float32 trainable masters), as the JAX server works on a
    new params tree."""

    def __init__(self, model, state_dict, processor: Processor, *,
                 threshold: Optional[float] = None,
                 depth_wire_dtype: str = "float32", device="cuda"):
        if depth_wire_dtype not in ("float32", "float16"):
            raise ValueError(f"depth_wire_dtype {depth_wire_dtype!r}")
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device).eval()
        if state_dict is not None:
            self.model.load_state_dict(
                {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
                 for k, v in state_dict.items()}, strict=True)
        cdtype = getattr(model, "dtype", torch.float32)
        if cdtype != torch.float32:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.dtype == torch.float32 and p.numel() >= _PRECAST_MIN_SIZE:
                        p.data = p.data.to(cdtype)
        self.processor = processor
        self.threshold = float(model.threshold if threshold is None else threshold)
        self._depth_wire_f16 = depth_wire_dtype == "float16"

    def _action_fields(self):
        return (("left_pick", "right_pick", "left_place", "right_place")
                if self.model.is_bimanual else ("pick", "place"))

    def _upload(self, batched: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        inputs = {}
        for name, arr in batched.items():
            x = torch.from_numpy(_wire(name, arr, self._depth_wire_f16)).to(self.device)
            if name in _BINARY_INPUTS:
                x = x.float() / 255.0       # k/255 restores soft values exactly
            elif name in _DEPTH_INPUTS:
                x = x.float()
            inputs[name] = x
        return inputs

    def predict(self, rgb=None, depth=None, mask=None, instruction: str = "",
                context: Optional[List[Dict]] = None,
                return_raw_output: bool = False):
        """One observation -> Action (batch-1 is predict_batch of one)."""
        return self.predict_batch(
            [dict(rgb=rgb, depth=depth, mask=mask, instruction=instruction,
                  context=context)], return_raw_output=return_raw_output)

    @torch.inference_mode()
    def predict_batch(self, observations: List[Dict],
                      pad_to: Optional[int] = None,
                      return_raw_output: bool = False):
        """K observations -> K Actions in one padded batch. ``pad_to``
        repeats the last observation so a pool always runs at one batch
        size; padded rows are dropped from the result."""
        n = len(observations)
        batched, spec = self._prepare(observations, pad_to)
        sample = self._preprocess(spec, self._upload(batched))
        out = self.model(sample)
        packed = self._decode(out, sample)[:n].cpu().numpy()   # the one fetch
        action = Action(**{f: packed[:, i]
                           for i, f in enumerate(self._action_fields())})
        if return_raw_output:
            return action, {k: v[:n].cpu().numpy() for k, v in out.items()
                            if isinstance(v, torch.Tensor)}
        return action

    # the stages of predict_batch, separately callable for timing

    def _prepare(self, observations: List[Dict], pad_to: Optional[int]):
        """Host: tokenize and assemble the raw records, pad the pool."""
        n = len(observations)
        if n == 0:
            raise ValueError("predict_batch needs at least one observation")
        raws = [self.processor.make_raw(
            rgb=o.get("rgb"), depth=o.get("depth"), mask=o.get("mask"),
            instruction=o.get("instruction", ""), context=o.get("context"))
            for o in observations]
        if pad_to and pad_to > n:
            raws = raws + [raws[-1]] * (pad_to - n)
        batched = _stack_raws(raws)
        return batched, self.processor._spec(batched)

    def _preprocess(self, spec, x: Dict[str, torch.Tensor]):
        """Device: the processor core on the uploaded raw inputs."""
        labels = {k: x[k] for k in spec.label_keys}
        sample = _core(spec, x.get("rgb"), x.get("depth"), x.get("mask"),
                       x.get("ctx_rgb"), x.get("ctx_depth"), x.get("ctx_mask"),
                       x.get("ctx_count"), labels)
        sample["instruction"] = x["instruction"]
        return sample

    def _decode(self, out, sample) -> torch.Tensor:
        """Device: heatmaps -> (B, fields, 2) float32 pixel actions."""
        decoded = decode_action(
            out, sample, is_bimanual=self.model.is_bimanual,
            constrain_pick_mask=getattr(self.model, "constrain_pick_mask", True),
            threshold=self.threshold)
        return torch.stack([decoded[f].float() for f in self._action_fields()],
                           dim=1)

    def warmup(self, input_size: int, pool: Optional[int] = None) -> None:
        """Run one request at a camera resolution (and, with ``pool``, one
        pooled batch) before the control loop: builds the kernel library and
        lets cuBLAS pick its algorithms."""
        rng = np.random.default_rng(0)
        obs = dict(rgb=rng.integers(0, 255, (input_size, input_size, 3),
                                    dtype=np.uint8),
                   depth=rng.random((input_size, input_size)).astype(np.float32),
                   mask=np.ones((input_size, input_size), np.float32),
                   instruction="warmup")
        if pool and int(pool) > 1:
            self.predict_batch([obs], pad_to=int(pool))
        else:
            self.predict(**obs)


class ServingPolicy:
    """Adapt a :class:`ServingModel` into the closed-loop evaluators' policy
    callable: raw observations in (``wants_raw``), preprocessing on the
    device; a list serves one padded pooled batch. Returns (Action, None)."""

    wants_raw = True

    def __init__(self, server: ServingModel):
        self.server = server

    def __call__(self, obs, pad_to: Optional[int] = None):
        if isinstance(obs, (list, tuple)):
            return self.server.predict_batch(list(obs), pad_to=pad_to), None
        return self.server.predict(**obs), None
