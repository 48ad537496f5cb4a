"""Batch-1 and pooled serving: camera frames + instruction -> pixel Action.

Counterpart of bifold_tpu/serving.py. The control loop's path: tokenization
and record assembly on the host, one upload per input tensor, then
preprocessing (``data.processor._core``), the forward and the heatmap
decode on the device, and one fetch of the packed pixel actions.

The wire keeps the JAX package's value semantics: rgb travels as uint8,
masks as k/255-quantized uint8 (binary masks exact, soft masks to 1/255),
depth as float32 or, with ``depth_wire_dtype="float16"``, float16.

    model = build_model(cfg, dtype=torch.bfloat16)
    server = ServingModel(model, state_dict, Processor(...), device="cuda")
    server = ServingModel.from_checkpoint("checkpoints/best.ckpt", cfg)
    action = server.predict(rgb, depth, mask, "fold the left sleeve in")

The deployment half (bifold_tpu/serving.py:105-184, 358-386, 467, 536-700):

- ``quantize="int8"``: weight-only symmetric int8 with one scale per output
  channel (and per layer of a stack), chosen and computed as the JAX
  package does (:func:`quantize_weights`). The int8 payloads and scales stay
  on the device and are dequantized in the compute dtype where the forward
  uses them, ``q.to(dtype) * scale.to(dtype)``.
- :meth:`ServingModel.from_checkpoint` serves a checkpoint the JAX trainer
  wrote, read without JAX (:mod:`bifold_tpu_torch.utils.checkpoint`).
- :meth:`ServingModel.export` writes the port's own artifact (not
  StableHLO): the served weights, the model config and compute dtype, the
  wire schema of one observation shape and pool size, and the processor
  with its tokenizer model; :meth:`ServingModel.load_exported` serves it
  without the caller's config.
- ``mesh=`` (bifold_tpu/serving.py:187-232, 294-303): every rank of a
  ``torch.distributed`` group builds the server with the same weights and
  calls it with the same observations, as JAX's multi-controller runs do.
  The weights are sharded by the family's plan
  (:mod:`~bifold_tpu_torch.parallel.sharding`): tp-sharded projections,
  each rank computing its heads, and fsdp-sharded large leaves, gathered
  for each request outside the transformer stacks and one block at a
  time inside them; int8 payloads shard like their weights, and a
  per-output-channel scale follows the output axis under tp and takes
  the fsdp rule on its own shape, as JAX plans its quantized tree. A pooled batch that
  the data ranks divide is cut over them and the actions and raw outputs
  are gathered; one that does not (batch 1) is served whole on every data
  rank. The pp, sp and ep axes replicate the server, as JAX's server
  (which never sets an active mesh) runs the whole model on every device.
  A model with MoE layers serves every batch whole on every rank: its
  layers then route the batch as one group, as JAX's server routes it.
  ``export`` from a sharded server raises.

A graph-conditioned model (the processor's ``requires_graph``) is served
in two dispatches per observation, as bifold_tpu/serving.py:421-437 and
:512-531 serve it: ``Processor.__call__`` builds the sample and its
point-cloud graph on the host (the graph is data-dependent), then the
forward and the decode run on the device. Its observations carry the
camera (``matrix_world_to_camera``, ``K``), which the JAX server's
``predict`` has no argument for (its graph path fails there on the
missing intrinsics); ``pad_to`` adds no rows, ``program_memory`` is None
and ``export`` raises, as in JAX.
"""

from __future__ import annotations

import copy
import re
import zipfile
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.models import build_model, decode_action, resolve_device
from bifold_tpu_torch.models.layers import MoEFeedForward
from bifold_tpu_torch.data.processor import Processor, _core

__all__ = ["ServingModel", "ServingPolicy", "ExportedServingModel",
           "ProgramMemory", "quantize_weights", "dequantize_weights", "shared_scales",
           "ARTIFACT_FORMAT"]

_BINARY_INPUTS = ("mask", "ctx_mask")
_DEPTH_INPUTS = ("depth", "ctx_depth")
_PRECAST_MIN_SIZE = 2 ** 16
# the JAX package's packing order and wire bytes per element
_WIRE_ORDER = ("rgb", "depth", "mask", "ctx_rgb", "ctx_depth", "ctx_mask",
               "ctx_count", "instruction")
ARTIFACT_FORMAT = "bifold_tpu_torch.serving/1"


def _stack_raws(raws):
    """Stack N make_raw records into one batched observation dict."""
    batched = {k: np.stack([np.asarray(r[k]) for r in raws])
               for k, v in raws[0].items() if isinstance(v, np.ndarray)}
    if "ctx_count" in raws[0]:
        batched["ctx_count"] = np.asarray([r["ctx_count"] for r in raws])
    return batched


def _wire_dtype(name: str, depth_f16: bool):
    """The wire type of one raw input."""
    if name in _BINARY_INPUTS or name in ("rgb", "ctx_rgb"):
        return np.uint8
    if name in ("instruction", "ctx_count"):
        return np.int32
    return np.float16 if depth_f16 and name in _DEPTH_INPUTS else np.float32


def _wire(name: str, arr: np.ndarray, depth_f16: bool) -> np.ndarray:
    """The host-side wire encoding of one raw input."""
    if name in _BINARY_INPUTS:
        return np.clip(np.round(arr.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)
    return arr.astype(_wire_dtype(name, depth_f16))


def _wire_schema(batched: Dict[str, np.ndarray], depth_f16: bool):
    """((name, byte offset, shape), ...) of the observation on the JAX
    package's packed wire (bifold_tpu/serving.py:69): the layout an
    artifact is pinned to."""
    schema, off = [], 0
    for name in _WIRE_ORDER:
        if name in batched:
            shape = tuple(int(d) for d in np.shape(batched[name]))
            schema.append((name, off, shape))
            off += int(np.prod(shape)) * np.dtype(_wire_dtype(name, depth_f16)).itemsize
    return tuple(schema)


def _spm_asset_bytes(processor) -> Optional[bytes]:
    """The spiece.model bytes behind ``processor``'s tokenizer, to embed in
    an artifact: the pinned asset, else what the tokenizer's build would
    resolve; None for the hashing fallback."""
    from bifold_tpu_torch.data.tokenizers import siglip_spm_path

    asset = getattr(processor, "spm_asset", None)
    if isinstance(asset, bytes):
        return asset
    if asset is not None:
        return Path(asset).read_bytes()
    if processor.autoprocessor_name:
        found = siglip_spm_path(processor.autoprocessor_name)
        if found is not None:
            return found.read_bytes()
    return None


# ---------------------------------------------------------------------------
# int8 weight-only quantization
# ---------------------------------------------------------------------------

QUANT_TAG = "__int8_q__"
# The JAX package keeps float every leaf whose param path has a segment that
# _QUANT_EXCLUDE matches (bifold_tpu/serving.py:117): the token and
# positional tables and the learned modality tokens and position
# embeddings, which are gathered or added, never a matmul operand. In the
# port's names those are exactly these (SigLIP's HF tables, CLIP's
# token_embedding and positional_embedding, the heads' tokens and position
# embeddings); HF's "embeddings." segment must not exclude the patch
# embedding, a conv matmul that stays quantized, and CLIP's
# text_projection and class_embedding are no such table. T5's token table
# (``shared``, tied to ``encoder.embed_tokens``) and its relative-position
# table are JAX ``embedding`` leaves.
_QUANT_EXCLUDE = re.compile(
    r"(^|\.)(token_embedding|position_embedding|token_type_embeddings)\.weight$"
    r"|(^|\.)(shared|embed_tokens|relative_attention_bias)\.weight$"
    r"|(^|\.)positional_embedding$"
    r"|^(text_token|image_token|context_pos_embedding|rgb_pos_embedding"
    r"|text_pos_embedding)$")
# the stacks JAX keeps as one leaf per parameter with a leading depth axis:
# HF and fusion "layers", CLIP "resblocks"
_STACK = re.compile(r"^(.*\.(?:layers|resblocks))\.(\d+)\.")


def _stack_depths(names) -> Dict[str, int]:
    """{stack prefix: depth} of the ``....layers.<i>.`` and
    ``....resblocks.<i>.`` stacks, which the JAX package stores as one leaf
    per parameter with a leading depth axis (its nn.scan layout, used when
    depth > 1)."""
    layers: Dict[str, set] = {}
    for name in names:
        m = _STACK.match(name)
        if m:
            layers.setdefault(m.group(1), set()).add(m.group(2))
    return {prefix: len(ids) for prefix, ids in layers.items()}


# parameters the port keeps in the JAX package's own layout: the MoE FFNs'
# router and expert weights, the cross-attention's DenseGeneral kernels and
# biases, the fusion registers
_JAX_LAYOUT = re.compile(r"\.(router|w1|b1|w2|b2|registers)$"
                         r"|\.cross_attention\.(query|key|value|out)\.(kernel|bias)$")


def _reduce_dims(name: str, w: torch.Tensor, depth: int = 1):
    """The dims one int8 scale covers. A parameter in JAX's layout
    (:data:`_JAX_LAYOUT`) reduces over JAX's axes for its leaf (axis 0 of a
    2-d leaf, axes 1 .. ndim-2 of a deeper one,
    bifold_tpu/serving.py:165-166), the leaf's depth axis dropped when it is
    a stack's: a stacked (E, D, H) expert weight over E and D, a stacked
    router (D, E) over D. Otherwise: a Linear weight (out, in) reduces
    over ``in`` (JAX: axis 0 of (in, out), or 1 of (depth, in, out)), CLIP's
    ``text_projection``, kept (in, out) as in JAX, over dim 0; a conv weight
    (out, in, kh, kw) over ``in`` and ``kw`` (JAX: axes 1-2 of (kh, kw, in,
    out)), a transposed conv's (in, out, kh, kw) over ``in`` and ``kw``
    alike (JAX's taps are flipped, which moves no value between scales), so
    one scale per output channel and kernel row."""
    if _JAX_LAYOUT.search(name):
        stacked = int(depth > 1)
        ndim = w.dim() + stacked
        axes = (0,) if ndim == 2 else range(1, ndim - 1)
        return tuple(a - stacked for a in axes)
    if w.dim() == 2:
        return (0,) if name.endswith("text_projection") else (1,)
    if w.dim() == 4:
        return (0, 3) if name.endswith("convt.weight") else (1, 3)
    raise NotImplementedError(f"int8 scales for a {w.dim()}-d weight")


def _jax_leaf_size(name: str, w: torch.Tensor, depth: int) -> int:
    """Elements of the JAX leaf ``w`` maps to: times the depth of its stack,
    and a third of CLIP's fused in-projection (JAX keeps q, k, v apart)."""
    size = w.numel() * (depth if depth > 1 else 1)
    return size // 3 if ".attn.in_proj_" in name else size


# XLA compiles the JAX package's absmax / 127.0 as absmax times the f32
# reciprocal of 127, which rounds differently in some elements
_INV_127 = float(np.float32(1) / np.float32(127))


def _quantize_leaf(w: torch.Tensor, dims=None, scale=None):
    """int8 payload and f32 scale (bifold_tpu/serving.py:121): the absmax
    over ``dims`` times f32(1/127), or the ``scale`` given."""
    wf = w.float()
    if scale is None:
        scale = wf.abs().amax(dim=dims, keepdim=True) * _INV_127
    q = torch.round(wf / scale.clamp_min(1e-30)).clamp(-127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantize_weights(weights: Dict[str, torch.Tensor], min_size: int = 2 ** 16):
    """Symmetric per-output-channel int8 of the tensors the JAX package
    quantizes (bifold_tpu/serving.py:135) when its params tree is mapped to
    these names by ``convert_bifold_inverse``: float32 or bfloat16 weights
    of two dims or more whose JAX leaf has at least ``min_size`` elements
    (a stacked leaf holds every layer of its stack), but the tables that
    :data:`_QUANT_EXCLUDE` names. ``weights`` maps the port's parameter
    names to tensors; each quantized one becomes ``{QUANT_TAG: int8,
    "scale": f32}``, computed where it lies. A one-dim tensor of a stack
    (a bias or LayerNorm parameter, JAX's (depth, n) leaf) is quantized
    against one (n,) scale that every layer of the stack shares: the
    absmax over the layers times f32(1/127), JAX's (1, n) scale leaf; each
    layer's entry holds that same scale tensor."""
    depths = _stack_depths(weights)
    out, shared = {}, {}
    for name, w in weights.items():
        m = _STACK.match(name)
        depth = depths[m.group(1)] if m else 1
        size = _jax_leaf_size(name, w, depth)
        if (_QUANT_EXCLUDE.search(name) or size < min_size
                or w.dtype not in (torch.float32, torch.bfloat16)
                or w.dim() + (depth > 1) < 2):
            out[name] = w
        elif w.dim() < 2:
            key = (m.group(1), name[m.end():])
            if key not in shared:
                layers = [weights[f"{key[0]}.{i}.{key[1]}"] for i in range(depth)]
                shared[key] = _quantize_leaf(torch.stack(layers), (0,))[1][0]
            q, scale = _quantize_leaf(w, scale=shared[key])
            out[name] = {QUANT_TAG: q, "scale": scale}
        else:
            q, scale = _quantize_leaf(w, _reduce_dims(name, w, depth))
            out[name] = {QUANT_TAG: q, "scale": scale}
    return out


def shared_scales(weights) -> Dict[str, str]:
    """{weight name: the name of the stack's layer-0 weight whose scale it
    shares} of the one-dim stacked entries of :func:`quantize_weights`
    (those names that JAX keeps as one (1, n) scale leaf), layer 0
    included."""
    out = {}
    for name, v in weights.items():
        m = _STACK.match(name)
        if isinstance(v, dict) and m and v[QUANT_TAG].dim() == 1:
            out[name] = f"{m.group(1)}.0.{name[m.end():]}"
    return out


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``q.to(dtype) * scale.to(dtype)``: the JAX package's rounding."""
    return q.to(dtype) * scale.to(dtype)


def dequantize_weights(weights, compute_dtype):
    """Inverse of :func:`quantize_weights`; identity on other entries."""
    return {name: dequantize(v[QUANT_TAG], v["scale"], compute_dtype)
            if isinstance(v, dict) else v for name, v in weights.items()}


class _Int8Weight(nn.Module):
    """Parametrization of a quantized weight: its originals are the int8
    payload and the f32 scale, and every use reads :func:`dequantize` of
    them in the compute dtype, so the weight stays int8 on the device."""

    def __init__(self, q, scale, dtype):
        super().__init__()
        self.dtype = dtype
        self._pair = (q, scale)

    def right_inverse(self, weight):
        pair, self._pair = self._pair, None
        return pair

    def forward(self, q, scale):
        return dequantize(q, scale, self.dtype)


@torch.no_grad()
def _install(model: nn.Module, weights: Dict, dtype) -> None:
    """Make ``weights`` (parameter name -> tensor, or a quantized entry of
    :func:`quantize_weights`) the model's parameters, in their dtypes; every
    parameter must be named."""
    params = dict(model.named_parameters())
    if set(weights) != set(params):
        raise ValueError(f"served weights do not match the model: missing "
                         f"{sorted(set(params) - set(weights))[:5]}, unexpected "
                         f"{sorted(set(weights) - set(params))[:5]}")
    for name, value in weights.items():
        param = params[name]
        module_name, _, attr = name.rpartition(".")
        shape = value[QUANT_TAG].shape if isinstance(value, dict) else value.shape
        if shape != param.shape:
            raise ValueError(f"{name}: shape {tuple(shape)}, the model has "
                             f"{tuple(param.shape)}")
        if isinstance(value, dict):
            param.requires_grad_(False)
            parametrize.register_parametrization(
                model.get_submodule(module_name), attr,
                _Int8Weight(value[QUANT_TAG].to(param.device),
                            value["scale"].to(param.device), dtype), unsafe=True)
        else:
            param.data = value.to(param.device)


def _served_weights(model: nn.Module) -> Dict:
    """The inverse of :func:`_install`: parameter name -> tensor, or the
    quantized entry of an int8 weight."""
    out = {}
    for name, module in model.named_modules():
        if parametrize.is_parametrized(module):
            for attr, originals in module.parametrizations.items():
                out[f"{name}.{attr}" if name else attr] = {
                    QUANT_TAG: originals.original0.detach(),
                    "scale": originals.original1.detach()}
    for name, p in model.named_parameters():
        if ".parametrizations." not in f".{name}":
            out[name] = p.detach()
    return out


class ProgramMemory(NamedTuple):
    """Device memory of one served request (``program_memory``): the bytes
    of the served weights, and the peak the request allocated above what
    was allocated before it."""
    weight_bytes: int
    peak_over_weights_bytes: int


def _tp_entry(value, tp, axis: int, blocks: int):
    """This tp rank's part of a served weight: a tensor, or an int8 entry
    whose scale is cut too where it spans the cut axis."""
    if not isinstance(value, dict):
        return tp.part(value, axis, blocks).contiguous()
    q, scale = value[QUANT_TAG], value["scale"]
    if scale.shape[axis] == q.shape[axis]:
        scale = tp.part(scale, axis, blocks).contiguous()
    return {QUANT_TAG: tp.part(q, axis, blocks).contiguous(), "scale": scale}


class ServingModel:
    """Serve a copy of ``model`` (its weights replaced by ``state_dict`` when
    given) on ``device``, in eval mode. Big float32 weights (>= 2**16
    elements) are cast to the model's compute dtype once, as the JAX server
    does; small ones (biases, LayerNorm) stay float32. With
    ``quantize="int8"`` the weights :func:`quantize_weights` picks (at
    ``quantize_min_size``) are held as int8 and scales instead, and nothing
    else is cast. The copy leaves the caller's module as it was (a model can
    be served mid-training without rounding its float32 trainable masters),
    as the JAX server works on a new params tree. ``mesh`` (a ``mesh``
    config node or a :class:`~bifold_tpu_torch.parallel.Mesh`) shards it
    over the default ``torch.distributed`` group (module docstring), the
    fsdp rule taking leaves of at least ``shard_min_size`` elements (the
    ``min_size`` of JAX's ``param_sharding``)."""

    def __init__(self, model, state_dict, processor: Processor, *,
                 threshold: Optional[float] = None,
                 depth_wire_dtype: str = "float32",
                 quantize: Optional[str] = None,
                 quantize_min_size: int = 2 ** 16, mesh=None, device="cuda",
                 shard_min_size: int = 2 ** 16):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize {quantize!r}; None or 'int8'")
        device = resolve_device(device)
        served = copy.deepcopy(model).to(device).eval()
        if state_dict is not None:
            served.load_state_dict(
                {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
                 for k, v in state_dict.items()}, strict=True)
        cdtype = getattr(model, "dtype", torch.float32)
        weights = {n: p.detach() for n, p in served.named_parameters()}
        if quantize == "int8":
            weights = quantize_weights(weights, quantize_min_size)
        elif cdtype != torch.float32:
            weights = {n: w.to(cdtype) if w.dtype == torch.float32
                       and w.numel() >= _PRECAST_MIN_SIZE else w
                       for n, w in weights.items()}
        placement = None
        if mesh is not None:
            from bifold_tpu_torch import parallel
            from bifold_tpu_torch.parallel.sharding import Placement, make_plan

            mesh = parallel.make_mesh(mesh)
            quantized = {n: tuple(v["scale"].shape) for n, v in weights.items()
                         if isinstance(v, dict)}
            plan = make_plan(served, dict(getattr(model, "config", {})).get("name"),
                             {**mesh.shape, "pp": 1, "ep": 1}, shard_min_size, quantized)
            if quantize == "int8":
                tp = Placement.tp_group(mesh)
                params = dict(served.named_parameters())
                for name, (axis, blocks) in plan.tp.items():
                    weights[name] = _tp_entry(weights[name], tp, axis, blocks)
                    params[name].data = tp.part(params[name].data, axis, blocks)
                _install(served, weights, cdtype)
                placement = Placement(served, plan, mesh, cut=False)
            else:
                _install(served, weights, cdtype)
                placement = Placement(served, plan, mesh)
        else:
            _install(served, weights, cdtype)
        self._setup(served, processor, threshold, depth_wire_dtype, quantize)
        self.mesh, self.placement = mesh, placement

    def _setup(self, model, processor, threshold, depth_wire_dtype, quantize):
        if depth_wire_dtype not in ("float32", "float16"):
            raise ValueError(f"depth_wire_dtype {depth_wire_dtype!r}")
        self.model = model
        self.device = next(model.parameters()).device
        self.processor = processor
        self.quantize = quantize
        self.threshold = float(model.threshold if threshold is None else threshold)
        self._depth_wire_f16 = depth_wire_dtype == "float16"
        self._experts = any(isinstance(m, MoEFeedForward) for m in model.modules())
        self.mesh = self.placement = None

    @classmethod
    def _served(cls, model, processor, threshold, depth_wire_dtype, quantize):
        """A server around ``model`` as it is (its weights installed)."""
        server = cls.__new__(cls)
        server._setup(model, processor, threshold, depth_wire_dtype, quantize)
        return server

    @classmethod
    def from_checkpoint(cls, checkpoint_path, cfg, threshold: Optional[float] = None,
                        depth_wire_dtype: str = "float32",
                        quantize: Optional[str] = None,
                        quantize_min_size: int = 2 ** 16, mesh=None,
                        device="cuda", processor: Optional[Processor] = None
                        ) -> "ServingModel":
        """Serve a checkpoint of the JAX trainer (bifold_tpu/serving.py:358)
        or the port's: the model from ``cfg["model"]``, its params (and
        ``text_unet``'s ``extra_vars["batch_stats"]``) converted by
        ``from_jax_variables`` and loaded with ``strict=True``, and the
        test-partition Processor from ``cfg["processor"]`` with the
        checkpoint's sibling ``spiece.model`` when there is one. The model
        computes in ``cfg["precision"]["compute_dtype"]``, float32 when the
        config names none, as the JAX trainer reads it (trainer.py:98; the
        JAX package's from_checkpoint builds float32 whatever the config
        says). Reads the file without JAX. ``mesh``: as the constructor
        takes it. ``processor`` replaces the one built from the config; a
        graph config needs it (the config's processor node has no graph
        sizes: JAX builds that Processor without them and fails at its
        first request), so without it a graph config raises here."""
        from bifold_tpu_torch.models.convert import from_jax_variables
        from bifold_tpu_torch.utils.checkpoint import load_checkpoint

        mcfg = dict(cfg["model"])
        if processor is None and dict(cfg["processor"]).get("requires_graph"):
            raise ValueError(
                "a graph-conditioned config needs the Processor's graph sizes: "
                "pass processor=Processor(cfg['processor'], num_nodes=..., "
                "neighbor_radius=..., voxel_size=...) (the dataset config's)")
        payload = load_checkpoint(checkpoint_path)
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            dict(cfg.get("precision") or {}).get("compute_dtype", "float32")]
        model = build_model(mcfg, dtype=dtype, device=device)
        sibling = Path(checkpoint_path).parent / "spiece.model"
        if processor is None:
            processor = Processor(dict(cfg["processor"]), partition="test",
                                  max_context_length=mcfg.get("context_length"),
                                  autoprocessor_name=mcfg.get("automodel_name"),
                                  spm_asset=sibling if sibling.exists() else None)
        state = from_jax_variables(mcfg["name"], payload["params"],
                                   payload.get("extra_vars"))
        return cls(model, state, processor,
                   threshold=threshold, depth_wire_dtype=depth_wire_dtype,
                   quantize=quantize, quantize_min_size=quantize_min_size,
                   mesh=mesh, device=device)

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
                return_raw_output: bool = False, matrix_world_to_camera=None, K=None):
        """One observation -> Action (batch-1 is predict_batch of one). The
        camera (``matrix_world_to_camera``, ``K``) is read by graph models
        only."""
        return self.predict_batch(
            [dict(rgb=rgb, depth=depth, mask=mask, instruction=instruction,
                  context=context, matrix_world_to_camera=matrix_world_to_camera, K=K)],
            return_raw_output=return_raw_output)

    def predict_batch(self, observations: List[Dict],
                      pad_to: Optional[int] = None,
                      return_raw_output: bool = False):
        """K observations -> K Actions in one padded batch. ``pad_to``
        repeats the last observation so a pool always runs at one batch
        size; padded rows are dropped from the result. A graph model serves
        the observations one at a time (module docstring)."""
        if self.processor.requires_graph:
            return self._predict_graph(observations, return_raw_output)
        batched, spec = self._prepare(observations, pad_to)
        return self._serve(batched, spec, len(observations), return_raw_output)

    def _predict_graph(self, observations: List[Dict], return_raw_output: bool):
        """The two-dispatch path: per observation, the host Processor, then
        the forward and the decode; the actions (and raw outputs) of all
        observations concatenated."""
        if not observations:
            raise ValueError("predict_batch needs at least one observation")
        packed, raws = [], []
        for o in observations:
            sample = self.processor(
                rgb=o.get("rgb"), depth=o.get("depth"), mask=o.get("mask"),
                instruction=o.get("instruction", ""), context=o.get("context"),
                matrix_world_to_camera=o.get("matrix_world_to_camera"), K=o.get("K"))
            with torch.inference_mode():
                batch = {k: torch.from_numpy(np.ascontiguousarray(v))[None].to(self.device)
                         for k, v in sample.items()
                         if isinstance(v, np.ndarray) and v.ndim > 0 and v.dtype != object}
                out = self._forward(batch)
                packed.append(self._decode(out, batch).cpu().numpy())
                if return_raw_output:
                    raws.append({k: v.cpu().numpy() for k, v in out.items()
                                 if isinstance(v, torch.Tensor)})
        packed = np.concatenate(packed)
        action = Action(**{f: packed[:, i] for i, f in enumerate(self._action_fields())})
        if return_raw_output:
            return action, {k: np.concatenate([r[k] for r in raws]) for k in raws[0]}
        return action

    def _forward(self, sample):
        if self.placement is not None:
            with self.placement.gathered():
                return self.model(sample)
        return self.model(sample)

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

    @torch.inference_mode()
    def _serve(self, batched, spec, n: int, return_raw_output: bool):
        """Upload, preprocess, forward, decode; the first ``n`` rows out.
        Under a mesh whose data ranks divide the batch, each computes its
        slice and the results are gathered."""
        sample = self._preprocess(spec, self._upload(batched))
        mesh = self.mesh
        rows = next(v.shape[0] for v in sample.values() if isinstance(v, torch.Tensor))
        split = (mesh is not None and mesh.data_size > 1 and rows % mesh.data_size == 0
                 and not self._experts)
        if split:
            from bifold_tpu_torch.parallel import shard_batch
            sample = shard_batch(sample, mesh=mesh)
        out = self._forward(sample)
        packed = self._decode(out, sample)
        raw = {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}
        if split:
            from bifold_tpu_torch.parallel.collectives import all_gather
            group = mesh.groups["data"]
            packed = all_gather(packed, group)
            if return_raw_output:
                raw = {k: all_gather(v, group) for k, v in raw.items()}
        packed = packed[:n].cpu().numpy()   # the one fetch
        action = Action(**{f: packed[:, i]
                           for i, f in enumerate(self._action_fields())})
        if return_raw_output:
            return action, {k: v[:n].cpu().numpy() for k, v in raw.items()}
        return action

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

    def program_memory(self, rgb=None, depth=None, mask=None,
                       instruction: str = "", context=None) -> Optional[ProgramMemory]:
        """Device memory of one request at this observation shape
        (bifold_tpu/serving.py:467 returns the compiled program's memory
        stats; eager PyTorch has no program, so this measures one request):
        the served weights' bytes and the peak the request allocates above
        them. None on the CPU, as JAX returns None where a backend has no
        memory analysis, and for a graph model, as JAX's."""
        if self.device.type != "cuda" or self.processor.requires_graph:
            return None
        weights = sum(t.numel() * t.element_size()
                      for t in (*self.model.parameters(), *self.model.buffers()))
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        base = torch.cuda.memory_allocated(self.device)
        self.predict(rgb=rgb, depth=depth, mask=mask, instruction=instruction,
                     context=context)
        torch.cuda.synchronize(self.device)
        return ProgramMemory(weights, torch.cuda.max_memory_allocated(self.device) - base)

    # ------------------------------------------------------------------
    # Deployment artifact
    # ------------------------------------------------------------------

    def export(self, path, rgb=None, depth=None, mask=None,
               instruction: str = "export", context=None, batch: int = 1):
        """Write a serving artifact for ONE observation shape (the given
        one) at ``batch`` pooled rows per call (bifold_tpu/serving.py:536):
        the port's own format, read by :meth:`load_exported` with
        ``torch.load(weights_only=True)``. It holds the served weights
        (bf16-precast, or int8 and scales), the BatchNorm buffers, the model
        config (which names the family) and compute dtype, the wire schema
        and depth-wire flag, the action fields and threshold, the processor
        config, ``max_context_length``,
        ``autoprocessor_name`` and the embedded sentencepiece model, the
        pool size, and a ``format`` field naming it. The model must come
        from ``build_model`` (its config is recorded). A graph model's
        refuses, as JAX's (bifold_tpu/serving.py:551-554)."""
        if self.processor.requires_graph:
            raise NotImplementedError(
                "graph-conditioned models build data-dependent graphs "
                "host-side; the one-dispatch export does not cover them")
        if self.mesh is not None:
            raise NotImplementedError(
                "export from a mesh-sharded server: the artifact holds one "
                "device's weights; export from a server without a mesh "
                "(bifold_tpu/serving.py:555-560 refuses it too)")
        config = getattr(self.model, "config", None)
        if config is None:
            raise ValueError("export records the model config: serve a model "
                             "built by bifold_tpu_torch.models.build_model")
        batch = max(1, int(batch))
        raw = self.processor.make_raw(rgb=rgb, depth=depth, mask=mask,
                                      instruction=instruction, context=context)
        schema = _wire_schema(_stack_raws([raw] * batch), self._depth_wire_f16)

        def host(v):
            return ({QUANT_TAG: v[QUANT_TAG].cpu(), "scale": v["scale"].cpu()}
                    if isinstance(v, dict) else v.cpu())

        payload = {
            "format": ARTIFACT_FORMAT,
            "model_config": dict(config),
            "compute_dtype": str(self.model.dtype).removeprefix("torch."),
            "weights": {k: host(v) for k, v in _served_weights(self.model).items()},
            # BatchNorm running statistics (text_unet), float32
            "buffers": {k: v.cpu() for k, v in self.model.named_buffers()},
            "quantize": self.quantize,
            "threshold": self.threshold,
            "schema": schema,
            "depth_wire_f16": self._depth_wire_f16,
            "fields": tuple(self._action_fields()),
            "processor_cfg": dict(self.processor.cfg),
            # None (not 0) when context is off: the Processor keys
            # process_context on max_context_length being given
            "max_context_length": (self.processor.max_context_length
                                   if self.processor.process_context else None),
            "autoprocessor_name": self.processor.autoprocessor_name,
            "spm_model_bytes": _spm_asset_bytes(self.processor),
            "batch": batch,
        }
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        return path

    @staticmethod
    def load_exported(path, device="cuda") -> "ExportedServingModel":
        return ExportedServingModel(path, device=device)


class ExportedServingModel:
    """Serve a :meth:`ServingModel.export` artifact: the model is rebuilt
    from the recorded config and given the recorded weights, so the caller
    passes no config; the host tokenizes with the embedded sentencepiece
    model. One observation layout and one pool size, as recorded: a bigger
    pool or another layout raises ``ValueError``. An artifact of the JAX
    package (a pickled ``jax.export`` program) is refused."""

    def __init__(self, path, device="cuda"):
        device = resolve_device(device)
        if not zipfile.is_zipfile(path):
            raise ValueError(
                f"{path} is not a serving artifact of the PyTorch port (a "
                "torch.save archive); artifacts of the JAX package hold a "
                "jax.export program and serve with bifold_tpu.serving only")
        p = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(p, dict) or p.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"{path}: artifact format "
                             f"{p.get('format') if isinstance(p, dict) else None!r}, "
                             f"this port reads {ARTIFACT_FORMAT!r}")
        dtype = getattr(torch, p["compute_dtype"])
        model = build_model(p["model_config"], dtype=dtype, device=device)
        _install(model, p["weights"], dtype)
        buffers = dict(model.named_buffers())
        saved = p.get("buffers", {})      # artifacts before text_unet have none
        if set(saved) != set(buffers):
            raise ValueError(f"{path}: the artifact's buffers {sorted(saved)[:3]} "
                             "do not match the model's")
        with torch.no_grad():
            for name, value in saved.items():
                buffers[name].copy_(value)
        self.processor = Processor(
            p["processor_cfg"], partition="test",
            max_context_length=p["max_context_length"],
            autoprocessor_name=p["autoprocessor_name"],
            spm_asset=p["spm_model_bytes"])
        self.server = ServingModel._served(
            model, self.processor, p["threshold"],
            "float16" if p["depth_wire_f16"] else "float32", p["quantize"])
        self.schema = tuple((str(n), int(o), tuple(int(d) for d in s))
                            for n, o, s in p["schema"])
        self.fields = tuple(p["fields"])
        self.batch = int(p["batch"])
        self.threshold = self.server.threshold
        self.quantize = p["quantize"]

    def predict(self, rgb=None, depth=None, mask=None, instruction: str = "",
                context: Optional[List[Dict]] = None,
                return_raw_output: bool = False):
        return self.predict_batch(
            [dict(rgb=rgb, depth=depth, mask=mask, instruction=instruction,
                  context=context)], return_raw_output=return_raw_output)

    def warmup(self, input_size: Optional[int] = None,
               pool: Optional[int] = None) -> None:
        """One request at the recorded observation shape (``input_size``
        and ``pool`` are accepted, as :meth:`ServingModel.warmup` takes
        them, and ignored: the artifact pins both)."""
        shapes = {name: shape for name, _, shape in self.schema}
        rng = np.random.default_rng(0)
        obs: Dict = {}
        if "rgb" in shapes:
            obs["rgb"] = rng.integers(0, 255, shapes["rgb"][1:], dtype=np.uint8)
        if "depth" in shapes:
            obs["depth"] = rng.random(shapes["depth"][1:]).astype(np.float32)
        if "mask" in shapes:
            obs["mask"] = np.ones(shapes["mask"][1:], np.float32)
        if "ctx_rgb" in shapes:
            obs["context"] = [dict(
                rgb=rng.integers(0, 255, shapes["ctx_rgb"][2:], dtype=np.uint8),
                depth=(rng.random(shapes["ctx_depth"][2:]).astype(np.float32)
                       if "ctx_depth" in shapes else None),
                mask=(np.ones(shapes["ctx_mask"][2:], np.float32)
                      if "ctx_mask" in shapes else None))
                for _ in range(shapes["ctx_rgb"][1])]
        self.predict(**obs, instruction="warmup")

    def predict_batch(self, observations: List[Dict],
                      pad_to: Optional[int] = None,
                      return_raw_output: bool = False):
        """Up to ``self.batch`` observations, padded to it with the last one
        (padded rows dropped). ``pad_to`` only checks that the pool fits."""
        n = len(observations)
        if pad_to and pad_to > self.batch:
            raise ValueError(f"pool of {pad_to} exceeds the exported batch "
                             f"{self.batch}; re-export with batch={pad_to}")
        if not 1 <= n <= self.batch:
            raise ValueError(f"the artifact serves 1..{self.batch} observations "
                             f"per call, got {n} (re-export with batch={n})")
        batched, spec = self.server._prepare(observations, self.batch)
        schema = _wire_schema(batched, self.server._depth_wire_f16)
        if schema != self.schema:
            raise ValueError(f"observation layout {schema} does not match the "
                             f"artifact's {self.schema}; an artifact covers "
                             "exactly one observation shape")
        return self.server._serve(batched, spec, n, return_raw_output)


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
