"""The sharding plan of the port's parameters over a mesh, and its placement.

Counterpart of bifold_tpu/parallel/__init__.py:188-284 (``_fsdp_spec``,
``_tp_axis``, ``param_sharding``). The plan is made on the JAX leaves, as
JAX makes it: the model's state dict goes through the port's own converter
(:func:`~bifold_tpu_torch.models.convert.to_jax_variables`) with every
element replaced by its index, so each JAX leaf (a stack's layers under
``blocks/block`` with a leading depth axis, kernels (in, out)) tells which
elements of which port tensors it holds, and along which axes. That map,
read off the converter itself, carries each decision to the port's tensors:

- ``min_size`` (2**16 elements) is tested on the JAX leaf, stacked;
- a leaf whose path holds a column-parallel name (``q_proj k_proj v_proj
  fc1 to_qkv``) or a row-parallel one (``out_proj fc2``) and a ``kernel``
  is sharded over ``tp`` on its output or input axis when ``tp`` divides
  it. Biases, LoRA's ``lora_a``/``lora_b``, T5's ``q k v o wi wo``,
  cross-attention's flax names, MoE experts and convolutions stay
  replicated over tp, as in JAX;
- any other leaf of at least ``min_size`` elements is sharded over
  ``fsdp`` on its largest axis that ``fsdp`` divides; tp-sharded kernels
  are not also fsdp-sharded;
- under ``pp``, the stacked leaves of a stack that runs as a pipe
  (:func:`pipelined`: a ``Transformer`` or CLIP stack whose depth ``pp``
  divides, of depth above 1, without MoE blocks, outside the
  ``BIFOLD_LN_KERNEL=fused`` wiring, as bifold_tpu/models/layers.py:554-626
  decides) are sharded over ``pp`` on their depth axis and nothing else
  (JAX's gpipe is manual over pp alone); other stacks stay whole on every
  pp rank, where JAX's rule would shard them and GSPMD gather them back;
- under ``ep``, the MoE experts' ``w1 b1 w2 b2`` are sharded over ``ep`` on
  their expert axis when ``ep`` divides the experts (``_EP_LEAVES``), and
  nothing else.

The port splits attention by heads: each tp rank holds the rows of its
heads of q, of k and of v, also in the fused ``to_qkv`` and CLIP's stacked
``in_proj_weight`` (JAX's GSPMD splits ``to_qkv``'s 3 x inner columns in
one contiguous run: the same axis, other elements). So a tp size must
divide the heads of every tp-sharded attention, which :func:`make_plan`
checks; JAX lets GSPMD split a head (ROADMAP section 3).

:class:`Placement` applies a plan to a model:

- a tp-sharded tensor is cut to this rank's part for good, and its module
  (:mod:`~bifold_tpu_torch.models.layers`) computes its heads or hidden
  units; replicated tensors that such a module uses only in part (the
  column-parallel biases, LoRA's adapters under a column-parallel base)
  get partial gradients on each tp rank, which :meth:`reduce_grads` sums
  over the tp group;
- each fsdp-sharded JAX leaf is a *unit*: this rank holds only its chunk
  of the leaf (along the sharded axis), and the port tensors it feeds are
  empty. The optimizer steps on the chunks (:attr:`step_params`), so its
  moments are sharded too. The tensors of a stack's blocks are gathered
  one block at a time (ZeRO-3, below); the others (embeddings, heads,
  decoders, projections: :attr:`stepwise`) for a whole step or request,
  :meth:`gather` rebuilding them from an all-gather over the fsdp group and
  :meth:`release` emptying them again;
- a pp stage keeps the layers of each pipelined stack that are its own
  (``[s * depth / pp, (s + 1) * depth / pp)``); the others' tensors are
  emptied for good, and the stack runs as a pipe
  (:mod:`~bifold_tpu_torch.parallel.pipeline`); an ep rank keeps its
  ``E / ep`` experts, and every MoE layer runs over the mesh
  (:func:`~bifold_tpu_torch.ops.moe.expert_parallel_ffn`);
- checkpoints hold full tensors: :meth:`full_state_dict` and
  :meth:`full_optimizer_state` gather them (every rank calls them), and
  :meth:`load_full_state_dict` / :meth:`load_optimizer_state` cut a full
  state to this rank's parts, whatever mesh wrote it.

A gather per block (ZeRO-3). Each block of a
:class:`~bifold_tpu_torch.models.layers.PipelineStack` that holds fsdp
tensors gets its *share* of the units (:class:`_Share`, the block's
``fsdp`` attribute): for a unit of stacked layers, the slab of the leaf
along its depth axis that is this block's (a slice of every rank's
chunk). The block runs on its whole tensors gathered just before it and
dropped just after (``torch.func.functional_call``,
:func:`~bifold_tpu_torch.models.layers.run_blocks`). Each gather and
reduce-scatter of a block (and of the tensors outside the blocks) is one
collective over its units' slices laid end to end (one per dtype), not one
per unit: a block of a SigLIP tower holds ten units.
Two mechanisms together make the backward per block too, because neither
does it alone:

- the gathered tensors are the outputs of an autograd Function
  (:class:`_GatherBlock`, whose input is the placement's zero-sized
  :attr:`anchor`): autograd hands it the block's weight gradients once
  they are all computed, and its backward reduce-scatters them into the
  units' chunk gradients there, so the whole model's gradient never exists
  at once. Differentiating the module parameters instead
  (``torch.autograd.grad`` over them) returns every gradient at the end;
- autograd would keep every gathered weight it saves for the backward (a
  linear saves its weight) alive until then, so the whole model would
  again be gathered at the backward's start: ``saved_tensors_hooks``
  (:meth:`_Share.saving`) keep a handle in place of each saved gathered
  weight (or view of one); the backward's first read in the block gathers
  the block's saved weights again, and each is dropped after its last
  read.
  Under ``remat`` the checkpoint's own hooks keep nothing and its
  recompute gathers the block again.

:attr:`Placement.peak_bytes` counts the whole fsdp tensors (and their
gradients, when they are reduced) alive at once during a step or a
request. Where fsdp shards a stacked leaf along its depth axis, a block's
layers lie whole in one rank's chunk or straddle two: the block's gather
takes its slab from those owners by broadcast (the pieces differ in size,
and gloo's all-gather wants equal sizes), and its backward all-reduces the
slab's gradient, each owner keeping its layers' part: the sums a
reduce-scatter of a per-layer gather makes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bifold_tpu_torch.models import layers as L
from bifold_tpu_torch.models.convert import to_jax_variables
from bifold_tpu_torch.models.norm import BatchNorm
from bifold_tpu_torch.ops import layer_norm as ln_ops
from bifold_tpu_torch.parallel.collectives import (TPGroup, all_gather,
                                                   all_reduce_sum_, broadcast_,
                                                   reduce_scatter, reduce_step_values)

__all__ = ["make_plan", "Plan", "Placement", "MIN_SIZE", "TP_COL", "TP_ROW"]

MIN_SIZE = 2 ** 16
TP_COL = ("q_proj", "k_proj", "v_proj", "fc1", "to_qkv")   # shard out dim
TP_ROW = ("out_proj", "fc2")                               # shard in dim
EP_LEAVES = ("w1", "b1", "w2", "b2")                        # expert axis first


def _fsdp_axis(shape, fsdp: int, min_size: int) -> Optional[int]:
    """``_fsdp_spec``: the largest axis ``fsdp`` divides, for a leaf of at
    least ``min_size`` elements (ties to the first)."""
    if fsdp <= 1 or int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % fsdp == 0 and shape[i] >= fsdp:
            return i
    return None


def _tp_axis(keys, shape) -> Optional[int]:
    """``_tp_axis``: the output axis of a column-parallel kernel, the input
    axis of a row-parallel one."""
    if len(shape) < 2 or "kernel" not in keys:
        return None
    if any(n in keys for n in TP_COL):
        return len(shape) - 1
    if any(n in keys for n in TP_ROW):
        return len(shape) - 2
    return None


@dataclasses.dataclass
class Box:
    """Where a JAX leaf's elements sit in one port tensor: the leaf's
    ``leaf`` slices hold the tensor's ``port`` slices, the leaf's axes
    ``axes[i]`` (None: extent 1) being the tensor's, those in ``flips``
    reversed (a transposed conv's taps)."""

    leaf: Tuple[slice, ...]
    port: Tuple[slice, ...]
    axes: Tuple[Optional[int], ...]
    flips: Tuple[int, ...] = ()

    def numel(self) -> int:
        return int(np.prod([s.stop - s.start for s in self.port]))

    def read(self, leaf: torch.Tensor, out: torch.Tensor) -> None:
        """``out[port] = leaf[leaf]`` (out is the port tensor)."""
        part = leaf[self.leaf]
        if self.flips:
            part = part.flip(self.flips)
        mapped = [a for a, j in enumerate(self.axes) if j is not None]
        part = part.reshape([part.shape[a] for a in mapped])
        order = sorted(range(len(mapped)), key=lambda i: self.axes[mapped[i]])
        region = out[self.port]
        region.copy_(part.permute(order).reshape(region.shape))

    def write(self, port: torch.Tensor, leaf: torch.Tensor) -> None:
        """``leaf[leaf] = port[port]``."""
        mapped = [a for a, j in enumerate(self.axes) if j is not None]
        order = sorted(range(len(mapped)), key=lambda i: self.axes[mapped[i]])
        region = port[self.port]
        dims = [region.shape[self.axes[mapped[i]]] for i in order]
        part = region.reshape(dims).permute(np.argsort(order).tolist())
        target = leaf[self.leaf]
        part = part.reshape(target.shape)
        target.copy_(part.flip(self.flips) if self.flips else part)


def _box(ids: np.ndarray, box: Tuple[slice, ...], k: int, starts: np.ndarray,
         shapes: List[tuple], names: List[str], arrays: Dict[str, np.ndarray]) -> Box:
    """The :class:`Box` of the port tensor ``k`` that fills the leaf's
    ``box``; raises unless every id there is one of the tensor's, placed by
    slicing, stacking, transposing and flipping: the box must equal a
    strided view of the tensor's own ids (``arrays``), compared element by
    element."""
    part = ids[box]
    own = arrays[names[k]].reshape(-1)
    shape = shapes[k]
    strides = [int(np.prod(shape[j + 1:])) for j in range(len(shape))]
    corner = int(part[(0,) * part.ndim]) - int(starts[k])
    axes, flips, deltas = [], [], []
    for a in range(ids.ndim):
        if part.shape[a] == 1:
            axes.append(None)
            deltas.append(0)
            continue
        step = [0] * ids.ndim
        step[a] = 1
        delta = int(part[tuple(step)]) - int(starts[k]) - corner
        j = next((j for j in range(len(shape)) if shape[j] > 1
                  and strides[j] == abs(delta)), None)
        if j is None:
            raise ValueError(f"{names[k]}: the converter's leaf axis {a} is "
                             "no axis of the tensor")
        axes.append(j)
        deltas.append(delta)
        if delta < 0:
            flips.append(a)
    lo = corner + sum((n - 1) * min(d, 0) for n, d in zip(part.shape, deltas))
    hi = corner + sum((n - 1) * max(d, 0) for n, d in zip(part.shape, deltas))
    if lo < 0 or hi >= own.size or not np.array_equal(part, np.lib.stride_tricks.as_strided(
            own[corner:], shape=part.shape, strides=[d * own.itemsize for d in deltas],
            writeable=False)):
        raise ValueError(f"{names[k]}: the converter moves it other than by "
                         "slicing, stacking and transposing")
    start = [int(i) for i in np.unravel_index(corner, shape)]
    for a in flips:
        start[axes[a]] -= part.shape[a] - 1
    port = [slice(i, i + 1) for i in start]
    for a, j in enumerate(axes):
        if j is not None:
            port[j] = slice(start[j], start[j] + part.shape[a])
    return Box(box, tuple(port), tuple(axes), tuple(flips))


def _slabs(ids: np.ndarray, starts: np.ndarray) -> Optional[List[Tuple[int, tuple]]]:
    """(tensor, box) of each slab when the leaf is slabs of whole boxes
    along at most one axis (a stack's layers, q/k/v of a fused
    projection), read off the lines through the leaf's first element;
    None otherwise."""
    lines = []
    for a in range(ids.ndim):
        at = [0] * ids.ndim
        at[a] = slice(None)
        lines.append(np.searchsorted(starts, ids[tuple(at)], side="right") - 1)
    varying = [a for a, line in enumerate(lines) if (line != line[0]).any()]
    if len(varying) > 1:
        return None
    axis = varying[0] if varying else 0
    line = lines[axis]
    cuts = [0] + [i for i in range(1, len(line)) if line[i] != line[i - 1]] + [len(line)]
    owners = [int(line[lo]) for lo in cuts[:-1]]
    if len(set(owners)) != len(owners):
        return None
    full = [slice(0, n) for n in ids.shape]
    return [(k, tuple(slice(lo, hi) if a == axis else full[a] for a in range(ids.ndim)))
            for k, lo, hi in zip(owners, cuts, cuts[1:])]


def _boxes(ids: np.ndarray, starts: np.ndarray, shapes: List[tuple],
           names: List[str], arrays: Dict[str, np.ndarray]) -> Dict[str, Box]:
    """The port tensors a leaf of element ids is made of, each with its
    :class:`Box`; raises where the converter did more than slice, stack,
    transpose and flip. Slabs (the usual case) cost one pass over the
    leaf; anything else finds each tensor's elements by owner."""
    if ids.size == 0:
        return {}
    slabs = _slabs(ids, starts)
    if slabs is not None:
        try:
            return {names[k]: _box(ids, box, k, starts, shapes, names, arrays)
                    for k, box in slabs}
        except ValueError:
            pass
    owner = (np.searchsorted(starts, ids.reshape(-1), side="right") - 1).reshape(ids.shape)
    out = {}
    for k in np.unique(owner):
        mask = owner == k
        box = []
        for a in range(ids.ndim):
            hit = np.nonzero(mask.any(axis=tuple(j for j in range(ids.ndim) if j != a)))[0]
            box.append(slice(int(hit[0]), int(hit[-1]) + 1))
        box = tuple(box)
        if mask[box].sum() != mask[box].size:
            raise ValueError(f"{names[k]}: its elements do not fill a box of the leaf")
        out[names[k]] = _box(ids, box, int(k), starts, shapes, names, arrays)
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


@dataclasses.dataclass
class Leaf:
    """One JAX params leaf: its path, stacked shape, spec (an axis name or
    None per axis) and, when it is sharded, the port tensors it is made
    of."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    boxes: Dict[str, Box]

    def axis(self, name: str) -> Optional[int]:
        return self.spec.index(name) if name in self.spec else None


@dataclasses.dataclass
class Plan:
    """The plan of one model over one mesh: ``leaves`` in JAX's terms (what
    the tests hold against ``param_sharding``), ``tp`` the port tensors cut
    over tp (name -> (axis, blocks)), ``partial`` the replicated tensors
    whose gradients are partial over tp, ``modules`` the modules that
    compute a tp shard, ``units`` the fsdp-sharded leaves, ``pipes`` the
    stacks that run as a pipe over pp (module name -> depth), ``ep`` the
    port tensors cut over ep on their axis 0 (the experts)."""

    family: str
    shape: Dict[str, int]
    leaves: List[Leaf]
    tp: Dict[str, Tuple[int, int]]
    partial: List[str]
    modules: List[str]
    units: List[Leaf]
    pipes: Dict[str, int] = dataclasses.field(default_factory=dict)
    ep: List[str] = dataclasses.field(default_factory=list)


def payload_name(name: str) -> str:
    """The port name of an int8 weight's payload (the parametrization's
    first original, :func:`bifold_tpu_torch.serving._install`)."""
    module, _, attr = name.rpartition(".")
    return f"{module}.parametrizations.{attr}.original0"


def scale_name(name: str) -> str:
    """The port name of an int8 weight's scale (its second original)."""
    return payload_name(name)[:-1] + "1"


# the probes of models a caller plans over and over (the advisor's layouts):
# None, or a dict keyed by the family, the state dict's names and shapes
# and the int8 weights (probe_cache)
_PROBES: Optional[dict] = None


@contextlib.contextmanager
def probe_cache():
    """Reuse :func:`_probe`'s result for models of equal structure while
    inside (the ids depend on names and shapes alone)."""
    global _PROBES
    outer = _PROBES
    _PROBES = {} if outer is None else outer
    try:
        yield
    finally:
        _PROBES = outer


def _probe(model: nn.Module, family: str, quantized: Optional[Dict[str, tuple]] = None):
    if _PROBES is None:
        return _probe_ids(model, family, quantized)
    key = (family, tuple((k, tuple(t.shape)) for k, t in model.state_dict(keep_vars=True).items()),
           tuple(sorted((quantized or {}).items())))
    if key not in _PROBES:
        _PROBES[key] = _probe_ids(model, family, quantized)
    return _PROBES[key]


def _probe_ids(model: nn.Module, family: str, quantized: Optional[Dict[str, tuple]] = None):
    """Run the converter on the model's state dict with each element
    replaced by its index (from 1): (params tree of ids, the tensors'
    starts, shapes and names, each tensor's ids by name, and the scales'
    tree). A weight in ``quantized`` (name -> its int8 scale's shape) is
    two tensors, its payload (:func:`payload_name`, the weight's shape)
    and its scale (:func:`scale_name`); the params tree holds the
    payload's ids where the weight's were, and the scales' tree (None
    without ``quantized``) is the converter's output for the scales' ids
    broadcast over their weights."""
    quantized = quantized or {}
    sd = model.state_dict(keep_vars=True)
    first: Dict[int, str] = {}
    names, shapes, starts = [], [], []
    total = 1

    def add(name, shape):
        nonlocal total
        names.append(name)
        shapes.append(tuple(shape))
        starts.append(total)
        total += int(np.prod(shape))

    for name, t in sd.items():
        if id(t) in first:
            continue
        first[id(t)] = name
        if name in quantized:
            add(payload_name(name), t.shape)
            add(scale_name(name), quantized[name])
        else:
            add(name, t.shape)
    dtype = np.int32 if total < 2 ** 31 else np.int64
    arrays = {name: np.arange(s, s + int(np.prod(shape)), dtype=dtype).reshape(shape)
              for name, s, shape in zip(names, starts, shapes)}

    def ids(key, t, scales=False):
        name = first[id(t)]
        if name not in quantized:
            return arrays[name]
        if scales:
            return np.broadcast_to(arrays[scale_name(name)], tuple(t.shape))
        return arrays[payload_name(name)]

    params, _ = to_jax_variables(family, {k: ids(k, t) for k, t in sd.items()})
    scales = (to_jax_variables(family, {k: ids(k, t, True) for k, t in sd.items()})[0]
              if quantized else None)
    return params, np.asarray(starts), shapes, names, arrays, scales


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_leaves(params, scales, starts, names, payloads):
    """(path, ids, kind) of every JAX leaf; a leaf of int8 payloads becomes JAX's
    quantized pair (bifold_tpu/serving.py ``quantize_weights``): the payload
    at ``path + (QUANT_TAG,)`` (:data:`bifold_tpu_torch.serving.QUANT_TAG`)
    and the scale at ``path + ("scale",)``, the
    leaf's ids taken once along JAX's reduced axes (axis 0 of a 2-d leaf,
    axes 1 .. ndim-2 of a deeper one)."""
    from bifold_tpu_torch.serving import QUANT_TAG

    for path, ids in _leaves(params):
        ids = np.asarray(ids)
        if not ids.size or names[int(np.searchsorted(starts, ids.flat[0], side="right")) - 1] \
                not in payloads:
            yield path, ids, None
            continue
        reduced = (0,) if ids.ndim == 2 else tuple(range(1, ids.ndim - 1))
        sids = np.asarray(_at(scales, path))
        yield path + (QUANT_TAG,), ids, "payload"
        yield path + ("scale",), sids[tuple(slice(0, 1) if a in reduced else slice(None)
                                            for a in range(sids.ndim))], "scale"


def _tp_modules(model: nn.Module):
    """The modules that can compute a tp shard
    (:class:`~bifold_tpu_torch.models.layers.TensorParallel`)."""
    for name, mod in model.named_modules():
        if isinstance(mod, L.TensorParallel):
            yield name, mod


def pipelined(model: nn.Module, pp: int) -> Dict[str, int]:
    """The stacks of ``model`` that run as a pipe over ``pp`` stages (name
    -> depth): JAX's conditions (bifold_tpu/models/layers.py:576-584) read
    off the config, never off a failure: ``pp`` > 1 divides a depth above 1,
    no MoE blocks, and the LayerNorm mode is not ``fused`` now (a stack
    placed for the pipe refuses to run in it later)."""
    if pp <= 1 or ln_ops.ln_mode() == "fused":
        return {}
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, L.PipelineStack):
            depth = len(mod.blocks)
            if depth > 1 and depth % pp == 0 and not mod.has_experts():
                out[name] = depth
    return out


def _under(name: str, prefixes) -> Optional[str]:
    """The first of ``prefixes`` that module-path ``name`` lies under."""
    return next((p for p in prefixes if name.startswith(p + ".")), None)


def make_plan(model: nn.Module, family: str, shape: Dict[str, int],
              min_size: int = MIN_SIZE, quantized: Optional[Dict[str, tuple]] = None
              ) -> Plan:
    """The plan of ``model`` (full tensors, not placed) of the family
    ``family`` over a mesh of axis sizes ``shape``. ``quantized``: the
    weights a server holds as int8 (name -> scale shape,
    :func:`bifold_tpu_torch.serving.quantize_weights`), planned as JAX
    plans its quantized tree (bifold_tpu/serving.py:294-303): the payload
    takes its kernel's spec, the scale its own (tp on the kernel's output
    axis where tp cuts that, else the fsdp rule on the scale's shape);
    their tensors are named by :func:`payload_name` and :func:`scale_name`.
    Raises ``NotImplementedError`` where tp does not divide the heads of an
    attention it shards, or would shard a module only in part."""
    tp, fsdp = int(shape.get("tp", 1)), int(shape.get("fsdp", 1))
    pp, ep = int(shape.get("pp", 1)), int(shape.get("ep", 1))
    pipes = pipelined(model, pp)
    quantized = dict(quantized or {})
    params, starts, shapes, names, arrays, scales = _probe(model, family, quantized)
    weight_of = {payload_name(n): n for n in quantized}
    scale_names = {scale_name(n) for n in quantized}
    leaves, ep_names = [], []
    for path, ids, kind in _jax_leaves(params, scales, starts, names, set(weight_of)):
        if ids.size and int(ids.min()) < 1:
            raise ValueError(f"{'/'.join(path)}: a leaf the converter made up, "
                             "not one of the model's tensors")
        spec = [None] * ids.ndim
        owner = (names[int(np.searchsorted(starts, ids.flat[0], side="right")) - 1]
                 if ids.size else "")
        axis = _tp_axis(path, ids.shape) if tp > 1 else None
        ep_axis = (1 if "blocks" in path and ids.ndim >= 2 else 0) if (
            ep > 1 and path and path[-1] in EP_LEAVES and "mlp" in path) else None
        if _under(owner, pipes) is not None:
            spec[0] = "pp"
            leaves.append(Leaf(path, tuple(ids.shape), tuple(spec), {}))
            continue
        if ep_axis is not None and ids.shape[ep_axis] % ep == 0:
            spec[ep_axis] = "ep"
            boxes = _boxes(ids, starts, shapes, names, arrays)
            for name, box in boxes.items():
                if box.axes[ep_axis] != 0:
                    raise ValueError(f"{name}: its experts are not its axis 0")
                ep_names.append(name)
            leaves.append(Leaf(path, tuple(ids.shape), tuple(spec), {}))
            continue
        if axis is not None and ids.shape[axis] % tp == 0:
            spec[axis] = "tp"
        else:
            axis = _fsdp_axis(ids.shape, fsdp, min_size)
            if axis is not None:
                spec[axis] = "fsdp"
        # the map to the port's tensors, for the leaves the plan shards
        boxes = _boxes(ids, starts, shapes, names, arrays) if any(spec) else {}
        want = {"payload": weight_of, "scale": scale_names}.get(kind)
        if want is not None and not all(n in want for n in boxes):
            raise ValueError(f"{'/'.join(path)}: a leaf of int8 and float tensors")
        leaves.append(Leaf(path, tuple(ids.shape), tuple(spec), boxes))

    # tp: the port tensors the sharded kernels are, each on its mapped axis
    # (an int8 payload as its weight; a scale follows its weight's cut)
    cut: Dict[str, set] = {}
    for leaf in leaves:
        axis = leaf.axis("tp")
        if axis is None:
            continue
        for name, box in leaf.boxes.items():
            if name not in scale_names:
                cut.setdefault(weight_of.get(name, name), set()).add(box.axes[axis])
    tp_cut, partial, modules = {}, [], []
    for prefix, mod in _tp_modules(model):
        own = {f"{prefix}.{k}": v for k, v in mod.tp_params().items()}
        sharded = [n for n in own if n in cut]
        if not sharded:
            continue
        mod.check_tp(tp, prefix)
        if len(sharded) != len(own):
            raise NotImplementedError(
                f"{prefix}: tp={tp} shards {sorted(sharded)} but not "
                f"{sorted(set(own) - set(sharded))}; the port shards a module's "
                "projections together")
        for name, (axis, blocks) in own.items():
            if cut[name] != {axis}:
                raise ValueError(f"{name}: the plan cuts axes {cut[name]}, the "
                                 f"module computes axis {axis}")
            tp_cut[name] = (axis, blocks)
        partial += [f"{prefix}.{k}" for k in mod.tp_partial()]
        modules.append(prefix)
    stray = set(cut) - set(tp_cut)
    if stray:
        raise NotImplementedError(f"tp={tp} shards {sorted(stray)[:3]}, which no "
                                  "module of the port computes in shards")
    units = [leaf for leaf in leaves if leaf.axis("fsdp") is not None]
    return Plan(family, dict(shape), leaves, tp_cut, partial, modules, units, pipes,
                sorted(ep_names))


def tp_local(t: torch.Tensor, tp: TPGroup, axis: int, blocks: int) -> torch.Tensor:
    """This tp rank's part of ``t`` (:meth:`TPGroup.part`), a new tensor."""
    return tp.part(t, axis, blocks).contiguous().clone()


def tp_full(local: torch.Tensor, tp: TPGroup, axis: int, blocks: int) -> torch.Tensor:
    """The inverse of :func:`tp_local` over the tp group (a collective)."""
    moved = local.movedim(axis, 0).contiguous()
    ranks = all_gather(moved, tp.group).chunk(tp.size)
    per = [r.chunk(blocks) for r in ranks]
    full = torch.cat([per[r][b] for b in range(blocks) for r in range(tp.size)])
    return full.movedim(0, axis).contiguous()


class _Unit:
    """An fsdp-sharded leaf: its chunk on this rank (leaf layout, the
    sharded axis first), and the port tensors it feeds."""

    def __init__(self, leaf: Leaf, params: Dict[str, torch.Tensor]):
        self.leaf = leaf
        self.axis = leaf.axis("fsdp")
        first = params[next(iter(leaf.boxes))]
        self.dtype, self.device = first.dtype, first.device
        self.trainable = first.requires_grad
        for name in leaf.boxes:
            p = params[name]
            if p.dtype != self.dtype or p.requires_grad != self.trainable:
                raise NotImplementedError(
                    f"{'/'.join(leaf.path)}: its tensors differ in dtype or "
                    "trainability; the port shards a leaf as one")
        self.shard: Optional[torch.Tensor] = None
        # the chunk's gradient, summed over the fsdp group block by block
        # in the backward (units of a stack's blocks)
        self.grad: Optional[torch.Tensor] = None

    def full_leaf(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The whole leaf (leaf layout) from full port tensors."""
        out = torch.empty(self.leaf.shape, dtype=self.dtype, device=self.device)
        for name, box in self.leaf.boxes.items():
            box.write(tensors[name], out)
        return out

    def chunk(self, leaf: torch.Tensor, n: int, i: int) -> torch.Tensor:
        return leaf.movedim(self.axis, 0).chunk(n)[i].contiguous()

    def unchunk(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the gathered chunks (sharded axis first)."""
        return gathered.movedim(0, self.axis)

    def chunk_axis(self, axis: int) -> int:
        """The chunk's axis that is the leaf's ``axis`` (not the sharded
        one)."""
        return axis + 1 if axis < self.axis else axis

    def leaf_axis(self, dim: int) -> int:
        """The inverse of :meth:`chunk_axis`."""
        return dim - 1 if dim <= self.axis else dim


@dataclasses.dataclass
class _Part:
    """What one unit holds of one block: the unit, the axis of its chunk
    that runs over the leaf's slab axis and the slab's [lo, hi) on it (dim
    None: the block holds the whole leaf), and the boxes of the block's
    tensors within the slab. ``owned``: the slab runs along the sharded
    axis itself (fsdp shards the leaf along its depth), so it lies in the
    chunks of one or two ranks, its *owners*, and [lo, hi) is on the
    leaf's sharded axis (the chunk's axis 0)."""

    unit: _Unit
    dim: Optional[int]
    lo: int
    hi: int
    boxes: Dict[str, Box]
    owned: bool = False

    def pieces(self, n: int):
        """(owner rank, lo, hi) of an owned slab's pieces, on the leaf's
        sharded axis, in rank order."""
        c = self.unit.leaf.shape[self.unit.axis] // n
        return [(r, max(self.lo, r * c), min(self.hi, (r + 1) * c)) for r in range(n)
                if max(self.lo, r * c) < min(self.hi, (r + 1) * c)]


class _Saved:
    """What a block's saved gathered weight becomes in the autograd graph:
    its name and view geometry (:meth:`_Share.saving`)."""

    __slots__ = ("name", "size", "stride", "offset")

    def __init__(self, name, t):
        self.name, self.size, self.stride = name, t.size(), t.stride()
        self.offset = t.storage_offset()


class _GatherBlock(torch.autograd.Function):
    """A block's whole fsdp tensors, gathered from the chunks; the backward
    sums their gradients over tp where they are partial, reduce-scatters
    them over fsdp into the units' chunk gradients, and gives the
    placement's anchor a zero-sized gradient (so that autograd runs it)."""

    @staticmethod
    def forward(ctx, anchor, share):
        full = share.gather()
        ctx.share = share
        ctx.set_materialize_grads(False)
        outs = tuple(full[n] for n in share.names)
        ctx.mark_non_differentiable(*(t for n, t in zip(share.names, outs)
                                      if n not in share.trainable))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.share.reduce(dict(zip(ctx.share.names, grads)))
        return ctx.share.placement.anchor.new_zeros(0), None


class _Share:
    """One block's share of the fsdp units (ZeRO-3): the block gathers it
    just before it runs and drops it just after (:meth:`weights`, which
    :func:`~bifold_tpu_torch.models.layers.run_blocks` opens through the
    block's ``fsdp`` attribute); the autograd graph keeps a handle in place
    of each gathered weight it saves and gathers that weight again when the
    backward reads it (:meth:`saving`); the block's weight gradients are
    reduce-scattered into the chunks' gradients as soon as autograd has
    them all (:class:`_GatherBlock`)."""

    def __init__(self, placement: "Placement", prefix: str, parts: List[_Part]):
        self.placement, self.prefix, self.parts = placement, prefix, parts
        self.names = sorted({n for part in parts for n in part.boxes})
        self.local = {n: n[len(prefix) + 1:] if prefix else n for n in self.names}
        self.trainable = {n for part in parts if part.unit.trainable for n in part.boxes}
        shapes, params = placement._full_shapes, placement._params
        self.nbytes = sum(int(np.prod(shapes[n])) * params[n].element_size()
                          for n in self.names)
        self.grad_bytes = sum(int(np.prod(shapes[n])) * params[n].element_size()
                              for n in self.trainable)
        self._live: Dict[int, str] = {}
        # gathered weights the backward has saved (name -> reads to come),
        # and those gathered for it and not read yet
        self._pending: Dict[str, int] = {}
        self._cache: Dict[str, torch.Tensor] = {}

    def _chunk(self, part: _Part) -> torch.Tensor:
        """This rank's slice of the part's unit chunk."""
        chunk = part.unit.shard.detach()
        return chunk if part.dim is None else chunk.narrow(part.dim, part.lo,
                                                           part.hi - part.lo)

    def gather(self, names=None) -> Dict[str, torch.Tensor]:
        """Whole tensors (of ``names``, default all of the block's) from
        the fsdp group's chunks: one all-gather of the chunks' slices laid
        end to end per dtype; the slabs that lie in their owners' chunks
        (:attr:`_Part.owned`), one broadcast from each owner per dtype."""
        p = self.placement
        n = p.mesh.fsdp
        groups: Dict[torch.dtype, list] = {}
        owned = []
        for part in self.parts:
            wanted = [k for k in part.boxes if names is None or k in names]
            if wanted and part.owned:
                owned.append((part, wanted))
            elif wanted:
                chunk = self._chunk(part)
                groups.setdefault(chunk.dtype, []).append((part, wanted, chunk))
        out: Dict[str, torch.Tensor] = {}
        if owned:
            self._gather_owned(owned, out)
        for picks in groups.values():
            flat = all_gather(torch.cat([c.reshape(-1) for _, _, c in picks]),
                              p.mesh.groups["fsdp"]).view(n, -1)
            at = 0
            for part, wanted, chunk in picks:
                ranks = flat[:, at:at + chunk.numel()].reshape(n * chunk.shape[0],
                                                               *chunk.shape[1:])
                at += chunk.numel()
                slab = part.unit.unchunk(ranks)
                for k in wanted:
                    if k not in out:
                        out[k] = torch.empty(p._full_shapes[k], dtype=chunk.dtype,
                                             device=chunk.device)
                    part.boxes[k].read(slab, out[k])
        for t in out.values():
            p._track(t)
        return out

    def _gather_owned(self, owned, out: Dict[str, torch.Tensor]) -> None:
        """The owned slabs' tensors into ``out``: each owner broadcasts its
        pieces of them (laid end to end, one broadcast per owner and dtype,
        every rank in the same order), and each slab is put together from
        its pieces. Broadcasts, because the pieces differ in size and gloo's
        all-gather wants equal sizes."""
        p = self.placement
        n, me, group = p.mesh.fsdp, p.mesh.fsdp_rank, p.mesh.groups["fsdp"]
        sends: Dict[tuple, list] = {}
        for part, _ in owned:
            for r, lo, hi in part.pieces(n):
                sends.setdefault((r, part.unit.dtype), []).append((part, lo, hi))
        got: Dict[int, list] = {}
        for (r, dtype), items in sends.items():
            shard = [part.unit.shard.detach() for part, _, _ in items]
            c = [part.unit.leaf.shape[part.unit.axis] // n for part, _, _ in items]
            sizes = [(hi - lo) * t[0].numel() for t, (_, lo, hi) in zip(shard, items)]
            if r == me:
                flat = torch.cat([t[lo - r * ci:hi - r * ci].reshape(-1)
                                  for t, ci, (_, lo, hi) in zip(shard, c, items)])
            else:
                flat = torch.empty(sum(sizes), dtype=dtype, device=shard[0].device)
            broadcast_(flat, r, group)
            for t, piece, (part, lo, hi) in zip(shard, flat.split(sizes), items):
                got.setdefault(id(part), []).append(piece.view(hi - lo, *t.shape[1:]))
        for part, wanted in owned:
            slab = part.unit.unchunk(torch.cat(got[id(part)]))
            for k in wanted:
                if k not in out:
                    out[k] = torch.empty(p._full_shapes[k], dtype=slab.dtype,
                                         device=slab.device)
                part.boxes[k].read(slab, out[k])

    def reduce(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """Sum the block's weight gradients over tp where they are partial,
        reduce-scatter the trainable units' slabs of them over fsdp (one
        collective, in float32) and add each rank's part to the units'
        chunk gradients."""
        p = self.placement
        p._note(sum(g.numel() * g.element_size() for g in grads.values() if g is not None))
        partial = [k for k in p.plan.partial if grads.get(k) is not None]
        if partial and p.mesh.tp > 1:
            flat = all_reduce_sum_(torch.cat([grads[k].float().reshape(-1) for k in partial]),
                                   p.mesh.groups["tp"])
            for k, g in zip(partial, flat.split([grads[k].numel() for k in partial])):
                grads[k] = g.view(grads[k].shape).to(grads[k].dtype)
        n = p.mesh.fsdp
        parts, pieces, owned = [], [], []
        for part in self.parts:
            u = part.unit
            if not u.trainable:
                continue
            shape = list(u.leaf.shape)
            if part.owned:
                shape[u.axis] = part.hi - part.lo
            elif part.dim is not None:
                shape[u.leaf_axis(part.dim)] = part.hi - part.lo
            slab = torch.zeros(shape, dtype=torch.float32, device=u.device)
            for k, box in part.boxes.items():
                if grads.get(k) is not None:
                    box.write(grads[k], slab)
            if part.owned:
                owned.append((part, slab.movedim(u.axis, 0)))
                continue
            parts.append(part)
            pieces.append(slab.movedim(u.axis, 0).chunk(n))
        if owned:
            self._reduce_owned(owned)
        if not parts:
            return
        # rank r's slices of every slab, then rank r + 1's: each rank's
        # part of the sum is one contiguous run
        mine = reduce_scatter(torch.cat([c[r].reshape(-1) for r in range(n) for c in pieces]),
                              p.mesh.groups["fsdp"])
        at = 0
        for part, chunks in zip(parts, pieces):
            u, size = part.unit, chunks[0].numel()
            if u.grad is None:
                u.grad = torch.zeros(u.shard.shape, dtype=torch.float32, device=u.device)
            target = (u.grad if part.dim is None else
                      u.grad.narrow(part.dim, part.lo, part.hi - part.lo))
            target.add_(mine[at:at + size].view(chunks[0].shape))
            at += size

    def _reduce_owned(self, owned) -> None:
        """The owned slabs' gradients summed over the fsdp group (one
        all-reduce of them laid end to end, in float32: the sums a
        reduce-scatter of them would make) and each owner's pieces added to
        its chunk's gradient."""
        p = self.placement
        n, me = p.mesh.fsdp, p.mesh.fsdp_rank
        flat = all_reduce_sum_(torch.cat([g.reshape(-1) for _, g in owned]),
                               p.mesh.groups["fsdp"])
        for (part, g), total in zip(owned, flat.split([g.numel() for _, g in owned])):
            u, total = part.unit, total.view(g.shape)
            c = u.leaf.shape[u.axis] // n
            for r, lo, hi in part.pieces(n):
                if r != me:
                    continue
                if u.grad is None:
                    u.grad = torch.zeros(u.shard.shape, dtype=torch.float32,
                                         device=u.device)
                u.grad[lo - r * c:hi - r * c].add_(total[lo - part.lo:hi - part.lo])

    @contextlib.contextmanager
    def weights(self):
        """The block's whole tensors by name within the block, gathered
        for the duration; differentiable (:class:`_GatherBlock`) where
        autograd records and the block trains."""
        if torch.is_grad_enabled() and self.trainable:
            full = dict(zip(self.names, _GatherBlock.apply(self.placement.anchor, self)))
        else:
            full = self.gather()
        self._live = {id(t): n for n, t in full.items()}
        try:
            yield {self.local[n]: t for n, t in full.items()}
        finally:
            self._live = {}

    @contextlib.contextmanager
    def saving(self):
        """While the block's forward runs: each tensor autograd saves that
        is one of the gathered weights (or a view of one) is kept as a
        handle; the backward's first read gathers again every saved weight
        still to be read (one all-gather), each read takes its view, and a
        weight is dropped after its last read. Inside
        ``torch.utils.checkpoint`` (``remat``) the checkpoint's own hooks
        take precedence: it keeps nothing, and its recompute gathers the
        block again."""
        def pack(t):
            name = self._live.get(id(t._base if t._base is not None else t))
            if name is None:
                return t
            self._pending[name] = self._pending.get(name, 0) + 1
            return _Saved(name, t)

        def unpack(saved):
            if not isinstance(saved, _Saved):
                return saved
            name = saved.name
            if name not in self._cache:
                # the first read of the block's backward gathers every
                # saved weight still to be read, in one collective
                self._cache.update(self.gather({name} | {
                    k for k, c in self._pending.items() if c > 0 and k not in self._cache}))
            full = self._cache[name]
            self._pending[name] = self._pending.get(name, 1) - 1
            if self._pending[name] <= 0:
                del self._cache[name], self._pending[name]
            return full.as_strided(saved.size, saved.stride, saved.offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield

    def drop(self) -> None:
        """Forget the saved weights of a backward that did not run."""
        self._pending.clear()
        self._cache.clear()


class Placement:
    """A :class:`Plan` applied to ``model`` on this rank of ``mesh``: see
    the module docstring. The model must hold full tensors (identical on
    every rank) when placed."""

    @staticmethod
    def tp_group(mesh) -> TPGroup:
        return TPGroup(mesh.groups["tp"], mesh.tp, mesh.tp_rank)

    def __init__(self, model: nn.Module, plan: Plan, mesh, cut: bool = True):
        """``cut=False``: the tp-sharded tensors hold this rank's parts
        already (a server's int8 weights, cut before they were installed)."""
        self.model, self.plan, self.mesh = model, plan, mesh
        self.tp = self.tp_group(mesh)
        self._params = dict(model.named_parameters())
        self._full_shapes = {n: tuple(p.shape) for n, p in self._params.items()}
        self._stages()
        self.attach_tp()
        if not cut:
            plan = dataclasses.replace(plan, tp={})
            self.plan = plan
        ep, j = mesh.shape.get("ep", 1), mesh.coords.get("ep", 0)
        with torch.no_grad():
            for name, (axis, blocks) in plan.tp.items():
                p = self._params[name]
                p.data = tp_local(p.data, self.tp, axis, blocks)
            for name in plan.ep:
                p = self._params[name]
                p.data = p.data.chunk(ep)[j].contiguous().clone()
            for name in self.foreign:
                p = self._params[name]
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.units = [_Unit(leaf, self._params) for leaf in plan.units]
        self.managed = sorted({n for u in self.units for n in u.leaf.boxes})
        covered: Dict[str, int] = {}
        for u in self.units:
            for name, box in u.leaf.boxes.items():
                covered[name] = covered.get(name, 0) + box.numel()
        for name in self.managed:
            if covered[name] != self._params[name].numel():
                raise NotImplementedError(
                    f"{name}: fsdp shards only part of it; the port shards a "
                    "tensor whole or not at all")
        with torch.no_grad():
            full = {n: self._params[n].data for n in self.managed}
            for u in self.units:
                u.shard = u.chunk(u.full_leaf(full), mesh.fsdp, mesh.fsdp_rank)
                if u.trainable:
                    u.shard = nn.Parameter(u.shard)
        self._live_bytes = self.peak_bytes = 0
        self._gathered = False
        self._shares()
        self.release()

    def _stages(self) -> None:
        """The pp stage's layers of every pipelined stack: ``owner`` maps
        each of their tensors to the stage that holds it, ``foreign`` lists
        the other stages' (cut away here), and each stack learns its
        stage."""
        pp, stage = self.mesh.shape.get("pp", 1), self.mesh.coords.get("pp", 0)
        self.owner: Dict[str, int] = {}
        for prefix, depth in self.plan.pipes.items():
            stack = self.model.get_submodule(prefix)
            per = depth // pp
            trains = [False] * pp
            for i, block in enumerate(stack.blocks):
                for n, p in block.named_parameters():
                    self.owner[f"{prefix}.{stack.BLOCKS}.{i}.{n}"] = i // per
                    trains[i // per] |= p.requires_grad
            if len(set(trains)) > 1:
                raise NotImplementedError(
                    f"{prefix}: pp={pp} stages differ in whether they hold trainable "
                    "layers; the port pipes a stack whose stages all train or none")
            stack.pipe = L.PipeStage(self.mesh, stage * per, (stage + 1) * per, trains[0])
        self.foreign = sorted(n for n, s in self.owner.items() if s != stage)
        self.staged = sorted(n for n, s in self.owner.items() if s == stage)

    def _shares(self) -> None:
        """Split the units between the stacks' blocks and the rest: each
        block of a stack (:class:`~bifold_tpu_torch.models.layers.PipelineStack`)
        whose tensors some unit holds gets its :class:`_Share` as its
        ``fsdp`` attribute; :attr:`stepwise` lists the fsdp tensors outside
        every block, which :meth:`gather` gathers for a whole step. A unit
        of stacked layers shares out its slab along the leaf's depth axis;
        where fsdp shards the leaf along that axis, each block's slab lies
        in the chunks of the ranks that own its layers (an owned part). A
        unit that holds a block's tensors and others raises, naming its
        leaf."""
        blocks = {}
        for prefix, mod in self.model.named_modules():
            if isinstance(mod, L.PipelineStack):
                for i, block in enumerate(mod.blocks):
                    blocks[f"{prefix}.{mod.BLOCKS}.{i}" if prefix else
                           f"{mod.BLOCKS}.{i}"] = block
        order = sorted(blocks, key=len, reverse=True)

        def block_of(name):
            return next((b for b in order if name.startswith(b + ".")), None)

        parts: Dict[str, List[_Part]] = {}
        stepwise = []
        for u in self.units:
            where = {n: block_of(n) for n in u.leaf.boxes}
            path = "/".join(u.leaf.path)
            if set(where.values()) == {None}:
                stepwise.append(_Part(u, None, 0, 0, u.leaf.boxes))
                continue
            if None in where.values():
                raise NotImplementedError(
                    f"{path}: its fsdp unit holds tensors of a stack's blocks and "
                    "others; the port gathers a block's units with the block")
            for b in sorted(set(where.values())):
                boxes = {n: box for n, box in u.leaf.boxes.items() if where[n] == b}
                lo = [min(box.leaf[a].start for box in boxes.values())
                      for a in range(len(u.leaf.shape))]
                hi = [max(box.leaf[a].stop for box in boxes.values())
                      for a in range(len(u.leaf.shape))]
                cut = [a for a, n in enumerate(u.leaf.shape) if (lo[a], hi[a]) != (0, n)]
                size = int(np.prod([h - l for l, h in zip(lo, hi)]))
                if len(cut) > 1 or size != sum(box.numel() for box in boxes.values()):
                    raise NotImplementedError(
                        f"{path}: block {b}'s tensors are no slab of the leaf")
                if not cut:
                    parts.setdefault(b, []).append(_Part(u, None, 0, 0, boxes))
                    continue
                d = cut[0]
                shifted = {n: dataclasses.replace(box, leaf=tuple(
                    slice(sl.start - lo[d], sl.stop - lo[d]) if a == d else sl
                    for a, sl in enumerate(box.leaf))) for n, box in boxes.items()}
                parts.setdefault(b, []).append(
                    _Part(u, None, lo[d], hi[d], shifted, owned=True) if d == u.axis
                    else _Part(u, u.chunk_axis(d), lo[d], hi[d], shifted))
        self._stepwise = _Share(self, "", stepwise)
        self.stepwise = self._stepwise.names
        self._held: Dict[str, torch.Tensor] = {}
        self.shares = []
        for b, block_parts in parts.items():
            share = _Share(self, b, block_parts)
            blocks[b].fsdp = share
            self.shares.append(share)
        self.blockwise = sorted(n for share in self.shares for n in share.names)
        self.anchor = (torch.zeros(0, device=next(iter(self._params.values())).device,
                                   requires_grad=True)
                       if any(share.trainable for share in self.shares) else None)

    # ------------------------------------------------------------------
    # the peak of whole fsdp tensors

    def _track(self, t: torch.Tensor) -> None:
        """Count a gathered tensor while it (or a view of it) lives."""
        nbytes = t.numel() * t.element_size()
        self._live_bytes += nbytes
        weakref.finalize(t, self._untrack, nbytes)
        self._note()

    def _untrack(self, nbytes: int) -> None:
        self._live_bytes -= nbytes

    def _note(self, extra: int = 0) -> None:
        """Raise the peak to what lives now plus ``extra`` bytes (whole
        gradients the caller holds)."""
        self.peak_bytes = max(self.peak_bytes, self._live_bytes + extra)

    def reset_peak(self) -> None:
        """Start :attr:`peak_bytes` afresh from what lives now."""
        self.peak_bytes = self._live_bytes

    @property
    def stepwise_bytes(self) -> int:
        """Bytes of the whole fsdp tensors outside the stacks' blocks and
        of their gradients, which a step holds at once when it reduces
        them."""
        return sum(int(np.prod(self._full_shapes[n])) * self._params[n].element_size()
                   * (1 + self._params[n].requires_grad) for n in self.stepwise)

    # ------------------------------------------------------------------

    def attach_tp(self) -> None:
        """Tell the modules the plan shards to compute their shard, and the
        BatchNorms to reduce over the data ranks."""
        for prefix in self.plan.modules:
            self.model.get_submodule(prefix).tp = self.tp
        for mod in self.model.modules():
            if isinstance(mod, BatchNorm):
                mod.group = self.mesh.groups["data"]

    @property
    def sharded(self) -> bool:
        """Whether any tensor is cut over the mesh (its checkpoints then
        gather, a collective every rank joins)."""
        return bool(self.plan.tp or self.units or self.plan.ep or self.owner)

    def _moment_names(self):
        """(the trainable tensors that are not fsdp-sharded and that this
        pp stage holds, by name; the trainable units): what
        :attr:`step_params` lists, in order."""
        foreign = set(self.foreign)
        own = [n for n, p in self._params.items()
               if p.requires_grad and n not in self.managed and n not in foreign]
        return own, [u for u in self.units if u.trainable]

    @property
    def step_params(self) -> List[torch.Tensor]:
        """What the optimizer updates: the trainable tensors that are not
        fsdp-sharded (tp parts included), then the trainable units' chunks."""
        own, units = self._moment_names()
        return [self._params[n] for n in own] + [u.shard for u in units]

    @property
    def step_names(self) -> List[str]:
        own, units = self._moment_names()
        return own + ["fsdp:" + "/".join(u.leaf.path) for u in units]

    @property
    def grad_params(self) -> List[Tuple[str, torch.Tensor]]:
        """The trainable module tensors the backward differentiates (this
        pp stage's layers of the pipelined stacks), but those the stacks'
        blocks gather: their gradients reach the units' chunks through
        :attr:`anchor`."""
        skip = set(self.foreign) | set(self.blockwise)
        return [(n, p) for n, p in self._params.items()
                if p.requires_grad and n not in skip]

    # ------------------------------------------------------------------
    # fsdp

    @torch.no_grad()
    def gather(self) -> None:
        """Rebuild the fsdp-sharded tensors outside the stacks' blocks
        (:attr:`stepwise`) from the fsdp group's chunks; the blocks gather
        their own as they run."""
        if not self._gathered:
            # held here, so that the peak counts them until release
            self._held = self._stepwise.gather()
            for name, t in self._held.items():
                self._params[name].data = t
        self._gathered = True

    def release(self) -> None:
        """Empty the fsdp-sharded tensors (their chunks stay) and drop the
        chunks' gradients."""
        for name in self.managed:
            p = self._params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._held = {}
        for u in self.units:
            u.grad = None
        for share in self.shares:
            share.drop()
        self._gathered = False

    @contextlib.contextmanager
    def gathered(self):
        held = self._gathered
        self.gather()
        try:
            yield
        finally:
            if not held:
                self.release()

    # ------------------------------------------------------------------
    # the step's reductions

    def reduce_grads(self, grads: List[torch.Tensor], loss, inter):
        """From the backward's gradients of :attr:`grad_params` to those of
        :attr:`step_params`, and the loss and its terms summed over the
        data ranks: partial gradients summed over tp; fsdp units'
        reduce-scattered over fsdp (the blocks' in the backward, the others'
        here, in one collective), then summed over ``dcn x dp``; the
        others, with the loss, over all data ranks in one flat buffer."""
        names = [n for n, _ in self.grad_params]
        by_name = dict(zip(names, grads))
        groups = self.mesh.groups
        # the units outside the blocks, as a block's are in its backward
        self._stepwise.reduce({n: by_name[n] for n in self.stepwise if n in by_name})
        own = [n for n in names if n not in self.managed]
        partial = [n for n in self.plan.partial if n in own]
        if partial and self.mesh.tp > 1:
            flat = all_reduce_sum_(torch.cat([by_name[n].float().reshape(-1)
                                              for n in partial]), groups["tp"])
            for n, part in zip(partial, flat.split([by_name[n].numel() for n in partial])):
                by_name[n] = part.view(by_name[n].shape).to(by_name[n].dtype)
        out, loss, inter = reduce_step_values([by_name[n] for n in own], loss, inter,
                                              groups["data"])
        trainable = [u for u in self.units if u.trainable]
        shards = [u.grad if u.grad is not None else torch.zeros(
            u.shard.shape, dtype=torch.float32, device=u.device) for u in trainable]
        for u in trainable:
            u.grad = None
        if shards and self.mesh.data_size > self.mesh.fsdp:
            flat = all_reduce_sum_(torch.cat([s.reshape(-1) for s in shards]),
                                   groups["replica"])
            shards = [p.view(s.shape) for p, s in zip(flat.split(
                [s.numel() for s in shards]), shards)]
        out += [s.to(u.shard.dtype) for s, u in zip(shards, trainable)]
        return out, loss, inter

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of :attr:`step_params`-aligned gradients, each
        element counted once: tp parts summed over tp, pp stages' layers
        over pp, experts over ep, fsdp chunks over fsdp, replicated tensors
        once."""
        own, _ = self._moment_names()
        staged, ep = set(self.staged), set(self.plan.ep)
        kinds = ["tp" if n in self.plan.tp else "pp" if n in staged else
                 "ep" if n in ep else "rep" for n in own] + \
            ["fsdp"] * (len(grads) - len(own))
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sq = {k: zero for k in ("rep", "tp", "pp", "ep", "fsdp")}
        for g, k in zip(grads, kinds):
            sq[k] = sq[k] + torch.sum(g.float() * g.float())
        total = sq.pop("rep")
        for k, v in sq.items():
            total = total + all_reduce_sum_(v.clone(), self.mesh.groups[k])
        return torch.sqrt(total)

    def all_finite(self, grads: List[torch.Tensor]) -> bool:
        """Whether every rank's gradients are finite (one verdict for all)."""
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).sum().float()
        return float(all_reduce_sum_(bad.reshape(1), None)[0]) == 0.0

    # ------------------------------------------------------------------
    # full state, for checkpoints

    def _full(self, local: Dict[str, torch.Tensor], unit_parts: List[torch.Tensor],
              units: List[_Unit], names: List[str]) -> Dict[str, torch.Tensor]:
        """Full port tensors ``names`` from their local parts: ``local``
        (tp parts or replicated) and the chunks of ``units`` (collectives)."""
        wanted = set(names)
        ep = set(self.plan.ep)
        out = {}
        for n in names:
            if n in self.managed:
                continue
            if n in self.owner:
                # a pipelined stack's layer: from the stage that holds it
                t = (local[n] if self.owner[n] == self.mesh.coords["pp"] else
                     torch.empty(self._full_shapes[n], dtype=self._params[n].dtype,
                                 device=self._params[n].device))
                out[n] = broadcast_(t.contiguous().clone(), self.owner[n],
                                    self.mesh.groups["pp"])
            elif n in ep:
                out[n] = all_gather(local[n].contiguous(), self.mesh.groups["ep"])
            elif n in self.plan.tp:
                out[n] = tp_full(local[n], self.tp, *self.plan.tp[n])
            else:
                out[n] = local[n]
        for u, part in zip(units, unit_parts):
            leaf = u.unchunk(all_gather(part.detach(), self.mesh.groups["fsdp"]))
            for n, box in u.leaf.boxes.items():
                if n not in wanted:
                    continue
                if n not in out:
                    out[n] = torch.empty(self._full_shapes[n], dtype=leaf.dtype,
                                         device=leaf.device)
                box.read(leaf, out[n])
        return out

    def _ep_local(self, full: torch.Tensor) -> torch.Tensor:
        """This ep rank's experts of a whole expert tensor."""
        return full.chunk(self.mesh.shape["ep"])[self.mesh.coords["ep"]].contiguous().clone()

    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every tensor whole (a collective)."""
        sd = self.model.state_dict()
        alias = {}
        for k, v in self.model.state_dict(keep_vars=True).items():
            alias.setdefault(id(v), k)
        params = {n: p.detach() for n, p in self._params.items()}
        full = self._full(params, [u.shard for u in self.units], self.units,
                          list(self._params))
        for k, v in self.model.state_dict(keep_vars=True).items():
            name = alias[id(v)]
            if name in full:
                sd[k] = full[name]
        return sd

    @torch.no_grad()
    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Make a full state dict (any mesh's checkpoint) this rank's."""
        missing = set(self.model.state_dict()) - set(sd)
        if missing:
            raise KeyError(f"state dict misses {sorted(missing)[:5]}")
        full = {}
        foreign, ep = set(self.foreign), set(self.plan.ep)
        for n, p in self._params.items():
            v = torch.as_tensor(sd[n]).to(p.device)
            if tuple(v.shape) != self._full_shapes[n] and n not in self.plan.tp:
                raise ValueError(f"{n}: shape {tuple(v.shape)}, the model has "
                                 f"{self._full_shapes[n]}")
            if n in foreign:
                continue
            if n in self.managed:
                full[n] = v.to(p.dtype)
            elif n in self.plan.tp:
                p.copy_(tp_local(v, self.tp, *self.plan.tp[n]))
            elif n in ep:
                p.copy_(self._ep_local(v))
            else:
                p.copy_(v)
        for u in self.units:
            u.shard.copy_(u.chunk(u.full_leaf(full), self.mesh.fsdp, self.mesh.fsdp_rank))
        if self._gathered:
            self._gathered = False
            self.gather()
        persistent = self.model.state_dict(keep_vars=True)
        for n, b in self.model.named_buffers():
            if n in persistent:
                b.copy_(torch.as_tensor(sd[n]))

    @torch.no_grad()
    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with each moment whole and keyed by
        the port tensor's name, as one process writes it (a collective)."""
        state = optimizer.state_dict()
        own, units = self._moment_names()
        names = [n for n, p in self._params.items() if p.requires_grad]
        for key in optimizer._MOMENTS:
            values = getattr(optimizer, key)
            if values is None:
                continue
            local = dict(zip(own, values[:len(own)]))
            full = self._full(local, list(values[len(own):]), units, names)
            state[key] = {n: full[n].detach().cpu().clone() for n in names}
        return state

    @torch.no_grad()
    def load_optimizer_state(self, optimizer, state: dict) -> None:
        """Cut a whole optimizer state (keyed by port names) to this rank's
        parts and load it."""
        own, units = self._moment_names()
        local = {k: v for k, v in state.items() if k not in optimizer._MOMENTS}
        for key in optimizer._MOMENTS:
            if key not in state:
                continue
            moments = state[key]
            cut = {}
            for n in own:
                if n in moments:
                    v = torch.as_tensor(moments[n])
                    cut[n] = (tp_local(v, self.tp, *self.plan.tp[n]) if n in self.plan.tp
                              else self._ep_local(v) if n in self.plan.ep else v)
            for u in units:
                if all(n in moments for n in u.leaf.boxes):
                    full = {n: torch.as_tensor(moments[n]).to(u.device, u.dtype)
                            for n in u.leaf.boxes}
                    cut["fsdp:" + "/".join(u.leaf.path)] = u.chunk(
                        u.full_leaf(full), self.mesh.fsdp, self.mesh.fsdp_rank).cpu()
            local[key] = cut
        optimizer.load_state_dict(local)

    def held_bytes(self, optimizer=None) -> int:
        """Bytes of parameters (and of ``optimizer``'s moments) this rank
        holds now: what lies between steps once :meth:`release` ran."""
        seen = set()
        total = 0
        for t in [*self._params.values(), *(u.shard for u in self.units)]:
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
        if optimizer is not None:
            for key in optimizer._MOMENTS:
                for v in getattr(optimizer, key) or ():
                    total += v.numel() * v.element_size()
        return total
