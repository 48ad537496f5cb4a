"""Mesh-layout advisor: run the real sharded train step for candidate
layouts without executing it, and report what it would move and compute.

Counterpart of bifold_tpu/parallel/advisor.py:171-344 (``analyze_layout``,
``scale_report``). JAX compiles the sharded step ahead of time and mines the
optimized HLO; the port has no compiled program to read, so it runs the
step itself, once, as rank 0 of ``n`` ranks:

- the process group is torch's fake one (backend ``"fake"`` over a
  ``FakeStore``): every collective returns at once and moves nothing;
- every tensor is a fake tensor on the CPU device
  (``torch._subclasses.fake_tensor.FakeTensorMode``): shapes, dtypes and
  strides without data, so the full-width flagship costs no memory; the
  kernels' plain versions stand in for the kernels (attention is routed to
  the flash path, as on the card);
- the step is :func:`~bifold_tpu_torch.parallel.make_train_step` on the
  model placed by :func:`~bifold_tpu_torch.parallel.place` under the
  layout, with Adam (JAX's advisor fixes Adam, lr 1e-4, clip 1.0) and the
  config's loss, on rank 0's slice of a processed global batch.

What the report reads off that run:

- **collectives**: the record of :mod:`~bifold_tpu_torch.parallel.collectives`
  (every collective of a step goes through it), per kind: count, result
  bytes and wire bytes by JAX's ring formulas;
- **FLOPs**: the formulas of ``torch.utils.flop_counter`` (those
  ``FlopCounterMode`` counts with: matmuls, convolutions, attention) over
  every aten op of the step;
- **HBM bytes**: the sum over every aten op of the bytes of its tensor
  inputs and outputs (views and allocations move nothing and are not
  counted): an upper figure, as if no two ops were fused; attention counts
  the flash kernels' own traffic (q, k, v, out, lse and the mask forward;
  those, dO, delta and dq, dk, dv backward), not its plain version's
  scores;
- **parameter and optimizer bytes per device**: the placement's arithmetic
  on the layout (tp parts, fsdp chunks, pp stages, ep experts):
  :meth:`~bifold_tpu_torch.parallel.sharding.Placement.held_bytes` and the
  Adam moments of :attr:`~bifold_tpu_torch.parallel.sharding.Placement.step_params`;
- **est**: lower bounds from the H100 datasheet (:data:`H100`): compute
  over the peak for the compute dtype, HBM bytes over HBM3's rate,
  collective wire bytes over one direction of NVLink 4. The largest names
  the bottleneck. Lower bounds, not predictions: overlap, fusion and
  latency are not modeled.

An MoE layer's expert-parallel route exchanges data-dependent row
counts, which fake tensors do not have: in the run each placed MoE layer
takes :func:`_moe_at_capacity` instead, the same route with every
expert's slots full at JAX's static capacity. Its all_to_alls then move
what JAX's compiled ``all_to_all`` moves (bifold_tpu/ops/moe.py:159-198):
two each way per layer, E x C rows of D float32, and its experts compute
over the same C slots; the report says so (``moe_exchange``). The rest of
the step is the port's: it has no dense (T, E, C) dispatch and combine,
and it repeats the dense layers on every rank of an ep group, where XLA
may cut their tokens over ep. A layout whose step fails (a tp that does
not divide the heads) is reported as ``{"mesh", "error"}`` and ranked
last, as JAX ranks a layout that does not compile.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from bifold_tpu_torch.parallel import TrainState

__all__ = ["analyze_layout", "scale_report", "H100"]

# NVIDIA H100 80GB HBM3 (SXM) datasheet figures, at its 700 W power limit
H100 = {
    "name": "H100 80GB HBM3 (SXM), 700 W",
    "peak_flops": {"bfloat16": 989e12,      # dense bf16 tensor cores
                   "float32": 67e12},       # f32 FMA, no tensor cores
    "hbm_bytes_per_s": 3.35e12,             # HBM3
    # NVLink 4: 900 GB/s per card in both directions together; a ring
    # collective's wire bytes leave a card in one direction, so they are
    # divided by one direction's 450 GB/s
    "link_bytes_per_s": 450e9,
}

ADAM = {"name": "adam", "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8,
        "weight_decay": 0}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "_local_scalar_dense"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _Traffic(TorchDispatchMode):
    """Bytes of every aten op's tensor inputs and outputs (views,
    allocations and the process group's own ops move nothing here), and
    FLOPs by the formulas of ``torch.utils.flop_counter`` (the registry
    ``FlopCounterMode`` counts with; its module tracker cannot follow the
    pipe's own ``autograd.grad`` calls, so the mode itself is not used)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.paused = 0
        self.registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        name = schema.name.split("::")[-1]
        if not (self.paused or view or name in _ALLOCATIONS
                or schema.name.startswith("c10d")):
            self.bytes += (sum(_nbytes(a) for a in args)
                           + sum(_nbytes(v) for v in kwargs.values()) + _nbytes(out))
        return out


@contextlib.contextmanager
def _flash_traffic(traffic: _Traffic):
    """Count the flash kernels' bytes in place of their plain versions'."""
    from bifold_tpu_torch.ops import flash_attention as fa

    plain = {n: getattr(fa, n) for n in ("flash_attention_fwd_plain",
                                         "flash_attention_bwd_plain")}

    def forward(q, k, v, key_mask=None, *, scale=None):
        traffic.paused += 1
        try:
            out, lse = plain["flash_attention_fwd_plain"](q, k, v, key_mask, scale=scale)
        finally:
            traffic.paused -= 1
        traffic.bytes += _nbytes((q, k, v, key_mask, out, lse))
        return out, lse

    def backward(q, k, v, key_mask, out, lse, do, *, scale=None):
        traffic.paused += 1
        try:
            grads = plain["flash_attention_bwd_plain"](q, k, v, key_mask, out, lse, do,
                                                       scale=scale)
        finally:
            traffic.paused -= 1
        # delta = rowsum(dO * O) reads both and writes lse's size; the
        # kernels read q, k, v, dO, lse, delta (and the mask), write dq, dk, dv
        traffic.bytes += _nbytes((out, do, lse)) + _nbytes((q, k, v, key_mask, do, lse, lse)) \
            + _nbytes(grads)
        return grads

    fa.flash_attention_fwd_plain = forward
    fa.flash_attention_bwd_plain = backward
    try:
        yield
    finally:
        for n, f in plain.items():
            setattr(fa, n, f)


class _FixedSeed(TrainState):
    """A step's state whose dropout seed is 0: a seed drawn from a
    generator is data, which fake tensors do not have."""

    def draw_seed(self) -> int:
        return 0


@contextlib.contextmanager
def _fake_group(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from bifold_tpu_torch import parallel

    if dist.is_initialized():
        raise RuntimeError("the advisor runs its own fake process group; call it "
                           "outside torch.distributed")
    hook = sys.excepthook               # a group wraps it to tag its rank
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook
        parallel._GROUPS.clear()       # their handles belonged to the fake group


def _moe_at_capacity(layer, x):
    """A placed :class:`~bifold_tpu_torch.models.layers.MoEFeedForward`'s
    forward for the fake run: the collectives and FLOPs of
    :func:`~bifold_tpu_torch.ops.moe.expert_parallel_ffn` with every
    expert's C slots full, C its capacity (JAX's): the first choices
    gathered over the data ranks (for the load-balance loss), this ep
    shard's tokens taken into E x C rows by index, the rows of each owner's
    experts sent to it, its experts' FFNs over their ep x C rows, the
    outputs sent back, gate-weighted and added to their tokens. Returns
    (out, aux) in the layer's shapes; the values mean nothing."""
    from bifold_tpu_torch.ops.moe import _choices, _expert_ffn, capacity
    from bifold_tpu_torch.parallel.collectives import (SELF, all_gather, all_to_all,
                                                       gather_from_group, group_size,
                                                       split_to_group)

    mesh, lead, d = layer.mesh, x.shape[:-1], x.shape[-1]
    x2 = x.to(layer.dtype).reshape(-1, d)
    probs = torch.softmax(x2.float() @ layer.router.float(), dim=-1)
    every = all_gather(_choices(probs, layer.top_k), mesh.groups["data"])
    e, t, t_loc, local = probs.shape[-1], every.shape[0], x2.shape[0], layer.w1.shape[0]
    ep = mesh.groups["ep"] if local != e else SELF
    n = group_size(ep)
    cap = capacity(t // n if t % n == 0 else t, e, layer.top_k, layer.capacity_factor)
    xs, ps = split_to_group(x2, 0, ep), split_to_group(probs, 0, ep)
    token = torch.zeros(e * cap, dtype=torch.long, device=x.device)    # each slot's token
    expert = torch.arange(e, device=x.device).repeat_interleave(cap)
    w = [getattr(layer, k).float() for k in ("w1", "b1", "w2", "b2")]
    rows = xs.float()[token]
    if ep is SELF:
        y = _expert_ffn(rows.view(e, cap, d), *w).reshape(e * cap, d)
    else:
        sent = [local * cap] * n
        got, _ = all_to_all(rows, sent, ep, recv_rows=sent)
        got = got.view(n, local, cap, d).transpose(0, 1).reshape(local, n * cap, d)
        y = _expert_ffn(got, *w).view(local, n, cap, d).transpose(0, 1)
        y, _ = all_to_all(y.reshape(e * cap, d), sent, ep, recv_rows=sent)
    out = torch.zeros((xs.shape[0], d), device=x.device).index_add(
        0, token, y * ps[token, expert][:, None])
    out = gather_from_group(out, 0, t_loc, ep).to(x.dtype).reshape(*lead, d)
    first = torch.zeros(e, device=x.device).index_add_(0, every[:, 0],
                                                       torch.ones(t, device=x.device))
    return layer.dropout(out), e * torch.sum(first / t * (probs.sum(dim=0) / t))


def _global_batch(model_cfg, processor_cfg, rows: int) -> Dict[str, torch.Tensor]:
    """``rows`` processed training samples at the config's shapes (blank
    frames, centered labels): real CPU tensors."""
    from bifold_tpu_torch.data import collate
    from bifold_tpu_torch.data.processor import Processor

    size = int(model_cfg["image_size"])
    context = model_cfg.get("context_length")
    # the model reads no graph features: the advisor's batch has none
    proc = Processor(dict(processor_cfg, requires_graph=False), partition="train",
                     max_context_length=context,
                     autoprocessor_name=model_cfg.get("automodel_name"), seed=0)
    frame = dict(rgb=np.zeros((size, size, 3), np.uint8),
                 depth=np.ones((size, size), np.float32),
                 mask=np.ones((size, size), np.float32))
    heads = (("left_pick", "right_pick", "left_place", "right_place")
             if model_cfg.get("is_bimanual") else ("pick", "place"))
    raw = proc.make_raw(**frame, instruction="fold the cloth in half",
                        context=[frame] * int(context or 0),
                        **{h: np.full((1, 2), size / 2, np.float32) for h in heads})
    out = proc.process_batch(collate([raw] * rows), "cpu",
                             generator=torch.Generator().manual_seed(0))
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def analyze_layout(mesh_cfg: dict, *, n_devices: Optional[int] = None, batch: int = 8,
                   model_cfg: Optional[dict] = None, processor_cfg: Optional[dict] = None,
                   loss_cfg: Optional[dict] = None, compute_dtype: str = "bfloat16",
                   chip: Optional[dict] = None, min_size: int = 2 ** 16,
                   samples: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Run the sharded train step once under ``mesh_cfg`` (axis sizes; dp
    -1 or absent takes what the others leave of ``n_devices``) on fake
    tensors and a fake group, and report traffic, residency and a roofline
    lower bound (module docstring) with JAX's report keys. ``model_cfg``,
    ``processor_cfg`` and ``loss_cfg`` are config nodes (the composed
    config's, as the CLI passes them); ``batch`` the global batch;
    ``min_size`` the fsdp rule's; ``samples`` processed samples at the
    config's shapes, at least as many as rank 0's slice (made here when
    not given)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, trainable_mask
    from bifold_tpu_torch.models.layers import MoEFeedForward
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel.collectives import recording, summarize

    if model_cfg is None or processor_cfg is None:
        raise ValueError("analyze_layout needs the config's model and processor nodes")
    chip = dict(chip or H100)
    layout = dict(mesh_cfg)
    n = int(n_devices or np.prod([v for k, v in layout.items()
                                  if k != "pp_microbatches" and v > 0]))
    shape = parallel._axis_sizes(layout, n)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]
    data = int(np.prod([shape[a] for a in parallel.BATCH_AXES]))
    if batch % data:
        raise ValueError(f"batch {batch} does not divide over {data} data ranks")
    if samples is None:
        samples = _global_batch(model_cfg, processor_cfg, batch // data)
    host = {k: v[:batch // data] for k, v in samples.items()}
    saved = os.environ.get("BIFOLD_ATTN_BACKEND")
    os.environ["BIFOLD_ATTN_BACKEND"] = "flash"   # the card's route, on fake tensors
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    traffic = _Traffic()
    try:
        with _fake_group(n):
            with fake:
                model = build_model(model_cfg, dtype=dtype, device="cpu", seed=None)
                trainable_mask(model, lora=bool(model_cfg.get("lora")))
                mesh = parallel.make_mesh(layout)
                placement = parallel.place(model, model_cfg["name"], mesh, min_size)
                for m in model.modules():
                    if isinstance(m, MoEFeedForward) and m.mesh is not None:
                        m.forward = functools.partial(_moe_at_capacity, m)
                opt = build_optimizer(dict(ADAM), placement.step_params, None,
                                      max_iters=100, gradient_clip=1.0,
                                      names=placement.step_names)
                sample = {k: fake.from_tensor(v) for k, v in host.items()}
                moe = (float(model_cfg.get("moe_aux_weight", 0.0))
                       if int(model_cfg.get("moe_experts", 0) or 0) else 0.0)
                step = parallel.make_train_step(
                    model, build_loss(dict(loss_cfg or {"name": "bce_gaussmap",
                                                        "is_bimanual": True})),
                    opt, moe_aux_weight=moe, placement=placement)
                with recording() as record, traffic, _flash_traffic(traffic):
                    step(_FixedSeed(opt, torch.Generator()), sample)
            params = placement.held_bytes()
            moments = sum(v.numel() * v.element_size() for key in opt._MOMENTS
                          for v in getattr(opt, key) or ())
    finally:
        if saved is None:
            os.environ.pop("BIFOLD_ATTN_BACKEND", None)
        else:
            os.environ["BIFOLD_ATTN_BACKEND"] = saved
    collectives = summarize(record)
    wire = sum(v["wire_bytes"] for v in collectives.values())
    total_flops = float(traffic.flops)
    est = {"compute_ms": 1e3 * total_flops / chip["peak_flops"][compute_dtype],
           "hbm_ms": 1e3 * traffic.bytes / chip["hbm_bytes_per_s"],
           "link_ms": 1e3 * wire / chip["link_bytes_per_s"]}
    est["bottleneck"] = max(("compute_ms", "hbm_ms", "link_ms"), key=lambda k: est[k])
    est["step_ms_lower_bound"] = est[est["bottleneck"]]
    return {"mesh": dict(shape), "n_devices": n, "batch_global": batch,
            "chip": chip["name"], "compute_dtype": compute_dtype,
            "flops_per_device": total_flops,
            "hbm_bytes_per_device": float(traffic.bytes), "hbm_bytes_unfused": True,
            "param_bytes_per_device": int(params),
            "opt_state_bytes_per_device": int(moments),
            "collectives": collectives, "collective_wire_bytes_per_device": wire,
            **({"moe_exchange": "static capacity"}
               if int(model_cfg.get("moe_experts", 0) or 0) else {}),
            "est": est}


def scale_report(layouts: list, **kwargs: Any) -> list:
    """:func:`analyze_layout` of each layout, sorted by the step-time
    lower bound (best first); a layout whose step fails is reported as
    ``{"mesh": ..., "error": ...}`` and ranked last."""
    from bifold_tpu_torch.parallel.sharding import probe_cache

    reports = []
    if kwargs.get("samples") is None and kwargs.get("model_cfg") and kwargs.get("processor_cfg"):
        # one processed batch for every layout: each takes its slice
        kwargs["samples"] = _global_batch(kwargs["model_cfg"], kwargs["processor_cfg"],
                                          int(kwargs.get("batch", 8)))
    with probe_cache():
        for layout in layouts:
            try:
                reports.append(analyze_layout(layout, **kwargs))
            except Exception as e:  # noqa: BLE001 — a failed layout is a result
                reports.append({"mesh": dict(layout),
                                "error": f"{type(e).__name__}: {e}"})
    return sorted(reports, key=lambda r: ("error" in r,
                                          r.get("est", {}).get("step_ms_lower_bound", 0.0)))
