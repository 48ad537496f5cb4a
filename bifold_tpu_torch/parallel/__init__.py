"""The train and eval steps, on one device or over a ``torch.distributed``
mesh.

Counterpart of bifold_tpu/parallel/__init__.py: ``distributed_init`` (:58),
``make_mesh`` (:126; :func:`make_mesh`, :func:`check_mesh`), ``shard_batch``
(:287), ``make_train_step`` (:330) and ``make_eval_step`` (:491), with the
sharding rules of ``param_sharding`` (:188-284) in
:mod:`~bifold_tpu_torch.parallel.sharding`, ``gpipe`` in
:mod:`~bifold_tpu_torch.parallel.pipeline`, ``ring_attention`` and
``expert_parallel_ffn`` in :mod:`~bifold_tpu_torch.ops`. Under JAX SPMD a
sharded step *is* the single-device step on the global batch; the port
keeps that meaning with one process per device, laid out as a (dcn, dp,
fsdp, tp, pp, sp, ep) grid, ep varying fastest:

- each data rank (``dcn x dp x fsdp``) holds a contiguous slice of the
  global batch; the ranks of a tp, pp, sp or ep group hold the same slice;
- each loss term says how it reduces over the batch: a mean term is scaled
  by local / global batch (``batch_share``), a sum term is left as it is,
  so the sums over the data ranks are the global batch's loss and gradient;
- a placement (:func:`place`) shards the model by its family's plan: tp
  ranks compute their heads and hidden units (Megatron's pair of
  collectives), fsdp ranks hold their chunks of the large leaves, the
  stacks' blocks gathering theirs one block at a time in both directions
  and the rest gathered before the forward and dropped after the update
  (:mod:`~bifold_tpu_torch.parallel.sharding`), pp stages hold their
  layers of each pipelined stack and run it as a GPipe pipe, ep ranks
  hold their experts, to which an all_to_all brings the routed tokens;
  MoE layers route over the global token order, as JAX does (the data
  ranks' router choices gathered); the step then reduces the gradients as
  the plan says (partial ones over tp, chunks reduce-scattered over fsdp,
  a block's as soon as its backward is done, and summed over ``dcn x
  dp``, the others with the loss in one flat buffer over the data ranks
  after the backward, all on the compute stream, without overlap), and
  the optimizer steps on this rank's parts;
- an sp group computes the same step on every rank, as JAX's GSPMD step
  does (JAX's model never calls the ring; the port exports it the same);
- the gradient norm (clipping, the ``grad_norm`` metric) counts each
  element once, whatever holds it;
- BatchNorm's train-mode statistics are global over the data ranks
  (:mod:`~bifold_tpu_torch.models.norm`);
- each data rank draws its dropout masks from (step seed, data rank); rank
  0 from the step seed itself, so a group of one steps exactly as no
  group does, and the ranks of a tp, pp, sp or ep group draw alike.

Without a placement, :func:`make_train_step` is the data-parallel step
over the default group.

``step(state, batch) -> (state, metrics)``: the model runs in ``train()``
mode on the processed batch with a dropout generator made fresh for this
step from the state's key generator (JAX splits a fresh dropout key per step
the same way), the loss is differentiated with respect to the trainable
parameters only (the optimizer's, ``requires_grad``; frozen towers get no
gradient and no dW work), and the optimizer updates them in place. Metrics
are device tensors, read by the caller when it needs them: ``loss``,
``grad_norm`` and ``grad_norm_trainable`` (the same value here: frozen
parameters carry no gradient), and the loss's per-head terms. A model with
MoE layers hands back their load-balance losses as ``moe_losses`` in its
train-mode output; with ``moe_aux_weight`` their mean, times the weight, is
added to the loss and reported as ``moe_load_balance``
(bifold_tpu/parallel/__init__.py:383-392).

BatchNorm running statistics (``text_unet``) move in the train-mode
forward, in place, on every step, whatever the optimizer does with its
gradients (JAX merges the mutated ``batch_stats`` unconditionally). A step
that raises before its optimizer update (an interrupt during the forward or
backward) puts them back, so that they never run ahead of the weights.

``eval_step(batch) -> output``: the model in ``eval()`` mode under
``torch.inference_mode()`` (no dropout, no autograd graph, so attention
takes the inference kernel), its previous mode restored afterwards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from bifold_tpu_torch.models.dropout import set_dropout_generator
from bifold_tpu_torch.optim import Optimizer
from bifold_tpu_torch.parallel.collectives import (SELF, all_reduce_values, rank,
                                                   reduce_step_values, world_size)
# the primitives JAX's parallel exports (bifold_tpu/parallel/__init__.py:46-55)
from bifold_tpu_torch.parallel.pipeline import gpipe
from bifold_tpu_torch.ops.moe import expert_parallel_ffn
from bifold_tpu_torch.ops.ring_attention import ring_attention

__all__ = ["TrainState", "make_train_step", "make_eval_step", "check_mesh",
           "make_mesh", "Mesh", "place", "distributed_init", "shard_batch",
           "world_size", "rank", "all_reduce_values", "MESH_AXES", "BATCH_AXES",
           "gpipe", "ring_attention", "expert_parallel_ffn"]

MESH_AXES = ("dcn", "dp", "fsdp", "tp", "pp", "sp", "ep")
# the axes the batch is cut over (bifold_tpu/parallel/__init__.py:89)
BATCH_AXES = ("dcn", "dp", "fsdp")


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     *, device=None, backend: Optional[str] = None) -> bool:
    """Join the default ``torch.distributed`` group: True once a group is up
    (a second call changes nothing), False, doing nothing, for a single
    process (no arguments and no launcher environment).

    Explicit arguments win; otherwise torchrun's environment:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``tcp://addr:port``),
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``. The device is ``device``, else
    ``cuda:LOCAL_RANK`` (which must exist), and a CUDA device becomes the
    current one (so ``"cuda"`` means it from here on); the backend
    ``backend``, else NCCL for a CUDA device and gloo for the CPU."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"distributed_init: init_method={init_method!r}, "
                         f"world_size={world_size!r}, rank={rank!r}; all three "
                         "are needed (arguments or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    if device is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"distributed_init: {device} requested, "
                               f"{torch.cuda.device_count()} CUDA devices here")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def _axis_sizes(mesh_cfg, world: int) -> Dict[str, int]:
    """The sizes of the seven axes a ``mesh`` config node asks for over
    ``world`` ranks (``dp: -1`` takes what ``dcn x fsdp x tp x pp x sp x ep``
    leave), as bifold_tpu/parallel/__init__.py:126-176 reads it."""
    node = dict(mesh_cfg or {})
    node.pop("pp_microbatches", None)
    unknown = set(node) - set(MESH_AXES)
    if unknown:
        raise KeyError(f"unknown mesh axes {sorted(unknown)} (have {MESH_AXES})")
    sizes = {a: int(node.get(a, 1)) for a in MESH_AXES if a != "dp"}
    if min(sizes.values()) < 1:
        raise ValueError(f"mesh axes must be positive: {sizes}")
    other = int(np.prod(list(sizes.values())))
    dp = int(node.get("dp", -1))
    if dp == -1:
        if world % other:
            raise ValueError(f"mesh dcn x fsdp x tp x pp x sp x ep = {other} does not "
                             f"divide {world} ranks")
        dp = world // other
    if dp < 1 or dp * other != world:
        raise ValueError(f"mesh {' x '.join(MESH_AXES)} = "
                         f"{' x '.join(str(dp if a == 'dp' else sizes[a]) for a in MESH_AXES)}"
                         f" != {world} ranks")
    return {a: dp if a == "dp" else sizes[a] for a in MESH_AXES}


def check_mesh(mesh_cfg, *, world: Optional[int] = None) -> int:
    """Check the config's ``mesh`` node against a group of ``world`` ranks
    (the default group's size) and return ``world``. The seven axes must
    multiply to the ranks (``dp: -1`` takes what the others leave).
    ``dcn`` is the slowest axis: with ranks laid out by node
    (``LOCAL_WORLD_SIZE`` ranks each, as torchrun lays them), a dcn group
    must hold whole nodes. What ``pp`` and ``ep`` do not divide (a stack's
    depth, the experts) stays whole, as JAX leaves it
    (:mod:`~bifold_tpu_torch.parallel.sharding`)."""
    world = world_size() if world is None else world
    sizes = _axis_sizes(mesh_cfg, world)
    per_dcn = world // sizes["dcn"]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", per_dcn) or per_dcn)
    if sizes["dcn"] > 1 and per_dcn % local:
        raise ValueError(f"mesh dcn={sizes['dcn']}: its groups of {per_dcn} ranks "
                         f"are not whole nodes of {local} ranks (LOCAL_WORLD_SIZE): "
                         "a node would straddle two dcn groups")
    return world


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ranks as a (dcn, dp, fsdp, tp, pp, sp, ep) grid, ``ep`` varying
    fastest, as JAX lays its devices out (``pp``, ``sp`` and ``ep`` after
    ``tp``, bifold_tpu/parallel/__init__.py:156-172). ``shape`` maps each
    axis to its size, ``coords`` this rank's position,
    ``pp_microbatches`` is the config's (0: each pipelined stack picks).
    ``groups`` holds this rank's group along each axis or set of axes (a
    ``torch.distributed`` group, None for the default one, or
    :data:`~bifold_tpu_torch.parallel.collectives.SELF` for one rank), and
    ``ranks`` the global ranks of the same groups in order:

    - one per axis (``tp``, ``fsdp``, ``pp``, ``sp``, ``ep``);
    - ``data``: the data ranks (``dcn x dp x fsdp``), the ranks that share
      every other coordinate with this one; each holds its slice of every
      batch, and the ranks of a tp, pp, sp or ep group hold the same slice;
    - ``replica``: the ``dcn x dp`` ranks that hold the same fsdp shard.
    """

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    groups: Dict[str, Any]
    ranks: Dict[str, list] = dataclasses.field(default_factory=dict)
    pp_microbatches: int = 0

    @property
    def world(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def fsdp(self) -> int:
        return self.shape["fsdp"]

    @property
    def data_size(self) -> int:
        """The data ranks: dcn x dp x fsdp."""
        return int(np.prod([self.shape[a] for a in BATCH_AXES]))

    @property
    def data_rank(self) -> int:
        """This rank's place among the data ranks (its batch slice)."""
        return int(np.ravel_multi_index([self.coords[a] for a in BATCH_AXES],
                                        [self.shape[a] for a in BATCH_AXES]))

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def fsdp_rank(self) -> int:
        return self.coords["fsdp"]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


# groups made once per (default group, mesh shape): every rank must call
# new_group for every group, in the same order
_GROUPS: Dict[tuple, Tuple[Dict[str, Any], Dict[str, list]]] = {}
_FAMILIES = {"tp": ("tp",), "fsdp": ("fsdp",), "pp": ("pp",), "sp": ("sp",),
             "ep": ("ep",), "data": BATCH_AXES, "replica": ("dcn", "dp")}


def _groups(shape: Dict[str, int], world: int, me: int):
    grid = np.arange(world).reshape([shape[a] for a in MESH_AXES])

    def family(keep):
        """The groups that vary over the axes ``keep``: this rank's handle
        and its ranks in order."""
        axes = [i for i, a in enumerate(MESH_AXES) if a in keep]
        rest = [i for i in range(len(MESH_AXES)) if i not in axes]
        moved = np.transpose(grid, rest + axes).reshape(-1, int(np.prod(
            [grid.shape[i] for i in axes])))
        mine = None
        for ranks in moved:
            ranks = [int(r) for r in ranks]
            if len(ranks) == 1:
                handle = SELF
            elif len(ranks) == world:
                handle = None
            else:
                handle = dist.new_group(ranks)
            if me in ranks:
                mine = handle, ranks
        return mine

    key = (id(dist.distributed_c10d._get_default_group()), tuple(shape.items()))
    if key not in _GROUPS:
        made = {name: family(keep) for name, keep in _FAMILIES.items()}
        _GROUPS[key] = ({k: v[0] for k, v in made.items()},
                        {k: v[1] for k, v in made.items()})
    return _GROUPS[key]


def make_mesh(mesh_cfg=None) -> Mesh:
    """The mesh of the config's ``mesh`` node over the default group (a
    mesh of one rank without a group), checked by :func:`check_mesh`;
    the counterpart of bifold_tpu/parallel/__init__.py:126 ``make_mesh``
    and of its active ``pp_microbatches`` (:98-120). A :class:`Mesh`
    passes through."""
    if isinstance(mesh_cfg, Mesh):
        return mesh_cfg
    world, me = world_size(), rank()
    check_mesh(mesh_cfg, world=world)
    shape = _axis_sizes(mesh_cfg, world)
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(
        me, [shape[a] for a in MESH_AXES]))))
    if world == 1:
        groups = {k: SELF for k in _FAMILIES}
        ranks = {k: [0] for k in _FAMILIES}
    else:
        groups, ranks = _groups(shape, world, me)
    micro = int(dict(mesh_cfg or {}).get("pp_microbatches", 0) or 0)
    return Mesh(shape, coords, me, groups, ranks, micro)


def shard_batch(batch: Dict[str, Any], *, shard: Optional[int] = None,
                shards: Optional[int] = None, mesh: Optional[Mesh] = None
                ) -> Dict[str, Any]:
    """Slice ``shard`` of a global batch cut into ``shards`` contiguous
    equal slices along the batch dimension of every tensor or array; other
    entries (instruction strings, ``label_keys``) pass through. By default
    the slice of this rank among ``mesh``'s data ranks (the ranks of a tp
    group get the same slice), or without a mesh among the default group's
    ranks."""
    if mesh is not None:
        shards = mesh.data_size if shards is None else shards
        shard = mesh.data_rank if shard is None else shard
    shards = world_size() if shards is None else shards
    shard = rank() if shard is None else shard

    def piece(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0:
            if x.shape[0] % shards:
                raise ValueError(
                    f"Batch dim {x.shape[0]} must be divisible by the {shards} "
                    "data-axis shards; adjust batch_size or the mesh config")
            n = x.shape[0] // shards
            return x[shard * n:(shard + 1) * n]
        return x

    return {k: piece(v) for k, v in batch.items()}


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the model's own parameters: the
    optimizer (its moments and update count) and ``key``, a CPU generator
    from which each step draws the seed of its dropout generator."""

    optimizer: Optimizer
    key: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, optimizer: Optimizer, seed: int = 0) -> "TrainState":
        return cls(optimizer, torch.Generator().manual_seed(seed))

    def draw_seed(self) -> int:
        """The next step's dropout seed, drawn from :attr:`key`."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.key))


def _rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` for a step drawn ``seed``: the step's
    own for rank 0, a distinct one for every other rank."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2 ** 63


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: Optimizer, *, moe_aux_weight: float = 0.0,
                    placement=None) -> Callable:
    """The train step over ``optimizer.params``. Without ``placement``: the
    trainable parameters, data-parallel over the default group when it has
    more than one rank (each rank is given its slice of the batch). With a
    :class:`~bifold_tpu_torch.parallel.sharding.Placement` (whose
    ``step_params`` the optimizer was built on): sharded as its plan says,
    over its mesh, the batch cut over the mesh's data ranks."""
    anchor = []
    if placement is None:
        mesh = make_mesh(None)
        grad_params = optimizer.params
    else:
        mesh = placement.mesh
        grad_params = [p for _, p in placement.grad_params]
        # the stacks' blocks gather their fsdp units and reduce-scatter
        # their gradients in the backward, which differentiating the
        # anchor runs (parallel/sharding.py)
        anchor = [placement.anchor] if placement.anchor is not None else []
        if mesh.world > 1:
            optimizer.global_norm = placement.grad_norm
            optimizer.all_finite = placement.all_finite
    device = (grad_params or optimizer.params)[0].device
    buffers = list(model.buffers())
    share = 1.0 / mesh.data_size
    sharded = placement is not None and mesh.world > 1
    gather = placement.gather if placement is not None else (lambda: None)
    release = placement.release if placement is not None else (lambda: None)

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        seed = state.draw_seed()
        model.train()
        set_dropout_generator(model, torch.Generator(device).manual_seed(
            _rank_seed(seed, mesh.data_rank)))
        before = [b.clone() for b in buffers]
        gather()
        try:
            out = dict(model(batch))
            moe_losses = out.pop("moe_losses", None)
            loss, inter = loss_fn(out, batch, batch_share=share)
            if moe_aux_weight and moe_losses is not None:
                aux = moe_losses.float().mean()
                loss = loss + moe_aux_weight * aux
                inter = {**inter, "moe_load_balance": aux}
            grads = list(torch.autograd.grad(loss, grad_params + anchor))[:len(grad_params)]
        except BaseException:
            release()
            with torch.no_grad():
                for b, saved in zip(buffers, before):
                    b.copy_(saved)
            raise
        finally:
            set_dropout_generator(model, None)
        if sharded:
            grads, loss, inter = placement.reduce_grads(grads, loss, inter)
        elif dist.is_initialized():
            grads, loss, inter = reduce_step_values(grads, loss, inter)
        gnorm = (placement.grad_norm(grads) if sharded else
                 torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads)))
        try:
            state.optimizer.step(grads)
        finally:
            release()
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "grad_norm_trainable": gnorm,
                   **{k: v.detach() for k, v in inter.items()}}
        return state, metrics

    return step


def place(model: nn.Module, family: Optional[str], mesh: Mesh,
          min_size: int = 2 ** 16):
    """Shard ``model`` (full tensors, the same on every rank) over ``mesh``
    by its family's plan (:mod:`~bifold_tpu_torch.parallel.sharding`) for
    training. A mesh with no fsdp, tp, pp or ep axis replicates everything
    and needs no family. Over more than one rank each MoE layer gets the
    mesh, and routes over the global batch the data ranks hold together."""
    from bifold_tpu_torch.models.layers import MoEFeedForward
    from bifold_tpu_torch.parallel import sharding

    if all(mesh.shape[a] == 1 for a in ("fsdp", "tp", "pp", "ep")):
        plan = sharding.Plan(family, dict(mesh.shape), [], {}, [], [], [])
    else:
        if family is None:
            raise ValueError(f"{mesh}: sharding needs the model family's converter")
        plan = sharding.make_plan(model, family, mesh.shape, min_size)
    placement = sharding.Placement(model, plan, mesh)
    if mesh.world > 1:
        for mod in model.modules():
            if isinstance(mod, MoEFeedForward):
                mod.mesh = mesh
    return placement


def make_eval_step(model: nn.Module) -> Callable:
    """The no-grad forward of ``model`` on a processed batch."""

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return model(batch)
        finally:
            model.train(was_training)

    return step
