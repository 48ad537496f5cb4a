"""Shared building blocks: LayerNorm, GELUs, attention, MLP, transformer.

Counterparts of bifold_tpu/models/layers.py:53-161, 164-211, 214-439,
511+ and 780-799 (``get_2d_sincos_pos_embed``). Parameters are float32
(or pre-cast: frozen ones by ``precast_frozen``, all big ones by the
serving path); every layer computes
in its ``dtype`` by casting weights at use, as flax does, with LayerNorm
statistics and GELUs in float32. Dropout sits where the JAX package puts it
(:class:`~bifold_tpu_torch.models.dropout.Dropout`, train mode only): the
LoRA input (``lora_dropout``), the attention output before and after its
projection and the FFN after the activation and after the second linear
(``dropout``, the fusion stack's).

``BIFOLD_LN_KERNEL`` (:mod:`bifold_tpu_torch.ops.layer_norm`) routes the
LayerNorms as in the JAX package: ``pallas`` sends every norm whose width is
a multiple of 128 through the LayerNorm kernels (:class:`_LayerNormFn`);
``fused`` also makes each pre-norm stack carry ``(residual, pending)`` so
that every residual add happens inside a norm (:class:`_FusedAddLayerNormFn`),
with one add left at the end of the stack. Unset, the same Function runs
the kernels' plain versions and nothing else changes. Every LayerNorm Function and both GELUs save what JAX's custom
VJPs save: the norm's input (or s), the f32 row stats and scale; the GELU's
input.

A fusion block's FFN may be a Mixture of Experts (:class:`MoEFeedForward`,
bifold_tpu/models/layers.py:308-400): the stack then hands each layer's
load-balance loss back through ``forward(..., aux=list)``, where JAX sows
it. ``remat`` (bifold_tpu/models/layers.py:473-504) recomputes each block
in the backward (:func:`run_blocks`), replaying its dropout draws (and
the tp collectives of its recompute, which every rank issues in the same
order).

Pipeline parallelism (:class:`PipelineStack`): a placement over a mesh
with ``pp`` stages gives each stack it pipelines (JAX's
``Transformer._maybe_pipeline`` conditions,
:func:`~bifold_tpu_torch.parallel.sharding.pipelined`) a :class:`PipeStage`,
and the stack then runs its stage's layers as a GPipe pipe
(:mod:`~bifold_tpu_torch.parallel.pipeline`), ``remat`` checkpointing each
layer inside the stage. Over any mesh of more than one rank an MoE layer
routes over the global token order and sends tokens to the ep rank that
holds their experts (:func:`~bifold_tpu_torch.ops.moe.expert_parallel_ffn`).

Tensor parallelism (:class:`TensorParallel`): the attention and MLP
modules whose projections JAX's rule shards over ``tp``
(:mod:`~bifold_tpu_torch.parallel.sharding`) compute their rank's heads or
hidden units when a placement gives them a ``tp`` group, Megatron's way:
:func:`~bifold_tpu_torch.parallel.collectives.copy_to_tp` before the
column-parallel projections, the row-parallel partial outputs summed over
the group and the bias added once after the sum (:func:`row_linear`), so
the fused add+LayerNorm of the next block receives the summed output.

Module names follow the reference torch checkpoints so that a converted
state dict loads with ``strict=True``:

- towers use the HF SigLIP encoder-layer names (``layer_norm1``,
  ``self_attn.{q,k,v,out}_proj``, ``layer_norm2``, ``mlp.fc1/fc2``), with
  peft's ``base_layer`` / ``lora_A.<adapter>`` / ``lora_B.<adapter>`` on the
  LoRA targets;
- the fusion stack uses the reference transformer's names: each layer is
  ``[PreNorm(Attention), PreNorm(FeedForward)]`` (``0.norm``,
  ``0.fn.to_qkv``, ``0.fn.to_out.0``, ``1.norm``, ``1.fn.net.0``,
  ``1.fn.net.3``);
- the CLIP towers use OpenAI CLIP's residual-block names
  (:class:`ClipResidualBlock` under ``resblocks``: ``ln_1``,
  ``attn.in_proj_weight`` / ``attn.in_proj_bias`` with q, k and v fused,
  ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``), the names
  bifold_tpu/models/convert.py:578-594 emits, with QuickGELU
  (:func:`quick_gelu`) and, in the text tower, causal attention.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bifold_tpu_torch.models.dropout import Dropout
from bifold_tpu_torch.models.lora import LORA_TARGETS, LoRALinear
from bifold_tpu_torch.ops import layer_norm as ln_ops
from bifold_tpu_torch.ops.attention import dot_product_attention
from bifold_tpu_torch.ops.moe import expert_parallel_ffn, moe_ffn
from bifold_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp

__all__ = ["LayerNorm", "gelu_tanh", "gelu_exact", "quick_gelu", "GELU",
           "linear", "MultiHeadAttention", "FeedForward", "MoEFeedForward",
           "TransformerBlock", "FusionBlock", "Transformer", "run_blocks",
           "PipelineStack", "PipeStage",
           "ClipResidualBlock", "ClipTransformer", "get_2d_sincos_pos_embed"]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def col_linear(x, weight, bias, dtype, tp=None, blocks: int = 1):
    """A column-parallel projection: ``weight`` holds this tp rank's output
    rows already, ``bias`` (replicated) is cut to them here."""
    if bias is not None:
        bias = (tp.part(bias, 0, blocks) if tp is not None else bias).to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def row_linear(x, layer: nn.Linear, dtype, tp=None):
    """A row-parallel projection: ``layer.weight`` holds this tp rank's input
    columns; the partial outputs are summed over the tp group (in float32)
    and the bias is added once, after the sum."""
    if tp is None:
        return linear(x, layer, dtype)
    y = reduce_from_tp(F.linear(x.to(dtype), layer.weight.to(dtype)).float(), tp.group)
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(dtype)


class TensorParallel:
    """What a module that can compute a tp shard declares: ``TP_CUT`` maps
    each tensor the plan cuts over tp (a name relative to the module) to
    (axis, blocks), and :meth:`tp_partial` names the replicated tensors it
    uses only in part. ``tp`` is None (the whole computation) or the
    :class:`~bifold_tpu_torch.parallel.collectives.TPGroup` a placement
    set (:mod:`~bifold_tpu_torch.parallel.sharding`)."""

    tp = None

    def tp_params(self):
        return dict(self.TP_CUT)

    def tp_partial(self):
        return []

    def check_tp(self, size: int, where: str) -> None:
        """Refuse a tp size that does not divide the heads: the port splits
        attention by heads, and GSPMD's split of a head has no counterpart."""
        heads = getattr(self, "heads", None)
        if heads is not None and heads % size:
            raise NotImplementedError(
                f"{where}: tp={size} does not divide its {heads} heads; the "
                "port shards attention by heads (JAX's GSPMD would split a "
                "head, ROADMAP section 3); pick a tp that divides the heads")


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm with ``_layer_norm``'s custom VJP
    (bifold_tpu/models/layers.py:52-101): saves only (x, mean, rstd, scale),
    x in the compute dtype and the row stats in f32, and recomputes xhat in
    the backward; scale and bias gradients in the parameters' dtypes.
    ``kernel``: through the LayerNorm kernels (the Pallas branch), else
    their plain versions (the XLA branch, the default mode, on any device).
    Differentiated op by op instead, autograd would keep the f32
    intermediates of every norm of a stack."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, kernel):
        fwd = ln_ops.ln_forward if kernel else ln_ops.ln_forward_plain
        out, mean, rstd = fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.bias_dtype, ctx.kernel = bias.dtype, kernel
        return out

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        bwd = ln_ops.ln_backward if ctx.kernel else ln_ops.ln_backward_plain
        dx, dscale, dbias = bwd(x, dy, mean, rstd, scale)
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None, None


class _FusedAddLayerNormFn(torch.autograd.Function):
    """(s, y) with s = x + delta and y = LN(s) in one kernel pass each way
    (``_fused_add_ln``, bifold_tpu/models/layers.py:104-129): saves (s,
    mean, rstd, scale); the backward folds the residual stream's cotangent
    into the norm's and returns it as the gradient of both x and delta."""

    @staticmethod
    def forward(ctx, x, delta, scale, bias, eps):
        s, y, mean, rstd = ln_ops.fused_ln_forward(x, delta, scale, bias, eps)
        ctx.save_for_backward(s, mean, rstd, scale)
        ctx.bias_dtype = bias.dtype
        return s, y

    @staticmethod
    def backward(ctx, ds_out, dy):
        s, mean, rstd, scale = ctx.saved_tensors
        ds, dscale, dbias = ln_ops.fused_ln_backward(s, dy, ds_out, mean, rstd,
                                                     scale)
        return ds, ds, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


class LayerNorm(nn.Module):
    """LayerNorm with the fast variance E[x^2] - E[x]^2 (clamped at 0),
    statistics in float32, output cast to ``dtype``. Written out rather than
    ``F.layer_norm`` so the reduction matches the JAX package's.

    ``forward(x, residual=delta)`` also does the pre-norm residual add and
    returns ``(s, y)``, s = x + delta and y = LN(s): one fused kernel pass
    under ``BIFOLD_LN_KERNEL=fused``, a plain add and the norm otherwise.
    Under ``pallas`` or ``fused`` a norm of width a multiple of 128 goes
    through the kernels (on the CPU, their plain versions)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x, residual=None):
        x = x.to(self.dtype)
        kernel = x.dim() >= 2 and ln_ops.use_kernel_ln(x.shape[-1])
        if residual is not None:
            residual = residual.to(self.dtype)
            if kernel and ln_ops.ln_mode() == "fused":
                return _FusedAddLayerNormFn.apply(x, residual, self.weight,
                                                  self.bias, self.eps)
            s = x + residual
            return s, self(s)
        return _LayerNormFn.apply(x, self.weight, self.bias, self.eps, kernel)


_SQRT_2_OVER_PI = 0.7978845608028654
_TANH_C = 0.044715


class _GeluTanhFn(torch.autograd.Function):
    """JAX's ``gelu_tanh`` custom VJP (bifold_tpu/models/layers.py:168-186):
    saves only x and recomputes tanh in the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        t = torch.tanh(_SQRT_2_OVER_PI * (xf + _TANH_C * xf ** 3))
        return (0.5 * xf * (1.0 + t)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        xf = x.float()
        t = torch.tanh(_SQRT_2_OVER_PI * (xf + _TANH_C * xf ** 3))
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _TANH_C * xf * xf)
        dgelu = 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * du
        return (dy.float() * dgelu).to(x.dtype)


class _GeluExactFn(torch.autograd.Function):
    """JAX's ``gelu_exact`` custom VJP (bifold_tpu/models/layers.py:189-210):
    saves only x and recomputes erf in the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return (xf * (0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0))))).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        xf = x.float()
        cdf = 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * xf * xf) * (1.0 / math.sqrt(2.0 * math.pi))
        return (dy.float() * (cdf + xf * pdf)).to(x.dtype)


class _QuickGeluFn(torch.autograd.Function):
    """CLIP's QuickGELU, x * sigmoid(1.702 x), with JAX's custom VJP
    (bifold_tpu/models/backbones/clip_backbone.py:32-48): computed in
    float32, saves only x and recomputes the sigmoid in the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float()
        return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        xf = x.float()
        s = torch.sigmoid(1.702 * xf)
        return (dy.float() * (s + 1.702 * xf * s * (1 - s))).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) in float32, cast back; its backward keeps only
    x."""
    return _QuickGeluFn.apply(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu(approximate='tanh') computed in float32, cast back; its backward
    keeps only x."""
    return _GeluTanhFn.apply(x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu computed in float32, cast back; its backward keeps
    only x."""
    return _GeluExactFn.apply(x)


class GELU(nn.Module):
    """Module form of :func:`gelu_exact` (the fusion MLP's activation)."""

    def forward(self, x):
        return gelu_exact(x)


class MultiHeadAttention(TensorParallel, nn.Module):
    """QKV attention. ``fused_qkv``: the fusion stack's bias-free ``to_qkv``
    and ``to_out.0`` (reference transformer.py naming); otherwise the towers'
    biased ``q_proj/k_proj/v_proj/out_proj`` (HF naming), with LoRA on q and
    v when ``lora_rank`` > 0. ``dropout`` applies to the attention output
    before and after the output projection. Under tp each rank holds the
    q, k and v rows of its heads and the matching columns of the output
    projection, and computes its heads."""

    def __init__(self, dim: int, heads: int, dim_head: int | None = None,
                 fused_qkv: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 1.0, lora_dropout: float = 0.0,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head or dim // heads
        self.fused_qkv = fused_qkv
        self.dtype = dtype
        self.dropout = Dropout(dropout)
        inner = self.dim_head * heads
        if fused_qkv:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
            self.to_out = nn.Sequential(nn.Linear(inner, dim))
            return
        for name in ("q_proj", "k_proj", "v_proj"):
            if lora_rank > 0 and name in LORA_TARGETS:
                proj = LoRALinear(dim, inner, rank=lora_rank, alpha=lora_alpha,
                                  dropout=lora_dropout, dtype=dtype)
            else:
                proj = nn.Linear(dim, inner)
            setattr(self, name, proj)
        self.out_proj = nn.Linear(inner, dim)

    @property
    def TP_CUT(self):
        if self.fused_qkv:
            return {"to_qkv.weight": (0, 3), "to_out.0.weight": (1, 1)}
        cut = {f"{self._base(p)}.weight": (0, 1) for p in ("q_proj", "k_proj", "v_proj")}
        return {**cut, "out_proj.weight": (1, 1)}

    def _base(self, name):
        return f"{name}.base_layer" if isinstance(getattr(self, name), LoRALinear) else name

    def tp_partial(self):
        if self.fused_qkv:
            return []
        out = [f"{self._base(p)}.bias" for p in ("q_proj", "k_proj", "v_proj")]
        for p in ("q_proj", "k_proj", "v_proj"):
            layer = getattr(self, p)
            if isinstance(layer, LoRALinear):
                out += [f"{p}.{n}" for n, _ in layer.named_parameters()
                        if n.startswith("lora_")]
        return out

    def _proj(self, name, x):
        layer = getattr(self, name)
        if isinstance(layer, LoRALinear):
            return layer(x, self.tp)
        return col_linear(x, layer.weight, layer.bias, self.dtype, self.tp)

    def forward(self, x, key_mask=None, *, legacy_query_mask=None):
        b, n, _ = x.shape
        tp = self.tp
        heads = self.heads // tp.size if tp is not None else self.heads
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        if self.fused_qkv:
            q, k, v = col_linear(x, self.to_qkv.weight, None, self.dtype).chunk(3, dim=-1)
        else:
            q, k, v = (self._proj(p, x) for p in ("q_proj", "k_proj", "v_proj"))
        shape = (b, n, heads, self.dim_head)
        out = dot_product_attention(q.reshape(shape), k.reshape(shape),
                                    v.reshape(shape), key_mask,
                                    legacy_query_mask=legacy_query_mask)
        out = self.dropout(out.reshape(b, n, heads * self.dim_head))
        proj = self.to_out[0] if self.fused_qkv else self.out_proj
        return self.dropout(row_linear(out, proj, self.dtype, tp))


class FeedForward(TensorParallel, nn.Module):
    """The towers' MLP: Linear -> ``activation`` (gelu-tanh, the SigLIP
    towers'; exact gelu in the transformer decoder) -> Linear, HF names
    ``fc1`` / ``fc2``; under tp each rank computes its hidden units."""

    TP_CUT = {"fc1.weight": (0, 1), "fc2.weight": (1, 1)}

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32,
                 activation=gelu_tanh):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.dtype = dtype
        self.activation = activation

    def tp_partial(self):
        return ["fc1.bias"]

    def forward(self, x):
        tp = self.tp
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        h = col_linear(x, self.fc1.weight, self.fc1.bias, self.dtype, tp)
        return row_linear(self.activation(h), self.fc2, self.dtype, tp)


class MoEFeedForward(nn.Module):
    """The Mixture-of-Experts FFN of a fusion block
    (bifold_tpu/models/layers.py:308-369): parameters ``router`` (D, E),
    ``w1`` (E, D, H), ``b1`` (E, H), ``w2`` (E, H, D), ``b2`` (E, D) in
    JAX's shapes, :func:`~bifold_tpu_torch.ops.moe.moe_ffn` over the input
    in ``dtype`` (its expert math in float32), then ``dropout``. Returns
    (out, aux): aux is the layer's Switch load-balance loss, which JAX sows
    into ``moe_losses``. Given a ``mesh`` (:func:`~bifold_tpu_torch.parallel.place`
    sets it for training over more than one rank), the layer takes its
    input as this data rank's slice of the global batch and runs over the
    mesh (:func:`~bifold_tpu_torch.ops.moe.expert_parallel_ffn`)."""

    mesh = None

    def __init__(self, dim: int, hidden_dim: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        e = num_experts
        self.router = nn.Parameter(torch.zeros(dim, e))
        self.w1 = nn.Parameter(torch.zeros(e, dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w2 = nn.Parameter(torch.zeros(e, hidden_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dropout = Dropout(dropout)
        self.dtype = dtype

    def forward(self, x):
        params = {k: getattr(self, k) for k in ("router", "w1", "b1", "w2", "b2")}
        if self.mesh is None:
            out, aux = moe_ffn(x.to(self.dtype), params, top_k=self.top_k,
                               capacity_factor=self.capacity_factor, return_aux=True)
        else:
            out, aux = expert_parallel_ffn(
                x.to(self.dtype), params, self.mesh, top_k=self.top_k,
                capacity_factor=self.capacity_factor, return_aux=True)
        return self.dropout(out), aux


class TransformerBlock(nn.Module):
    """Pre-norm residual block with HF SigLIP encoder-layer names:
    x + attn(ln1(x)); x + mlp(ln2(x)). Given ``pending`` (the fused wiring
    of bifold_tpu/models/layers.py:430-439), the input is (x, pending) with
    x + pending the block's true input, both adds happen inside the norms,
    and it returns (s2, mlp_out) for the next block."""

    def __init__(self, dim, heads, mlp_dim, dim_head=None, lora_rank=0,
                 lora_alpha=1.0, lora_dropout=0.0, ln_eps=1e-6,
                 dtype=torch.float32, activation=gelu_tanh):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim, ln_eps, dtype)
        self.self_attn = MultiHeadAttention(
            dim, heads, dim_head, fused_qkv=False, lora_rank=lora_rank,
            lora_alpha=lora_alpha, lora_dropout=lora_dropout, dtype=dtype)
        self.layer_norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = FeedForward(dim, mlp_dim, dtype, activation)

    def forward(self, x, key_mask=None, *, pending=None,
                legacy_query_mask=None):
        if pending is None:
            x = x + self.self_attn(self.layer_norm1(x), key_mask,
                                   legacy_query_mask=legacy_query_mask)
            return x + self.mlp(self.layer_norm2(x))
        s1, n1 = self.layer_norm1(x, residual=pending)
        a = self.self_attn(n1, key_mask, legacy_query_mask=legacy_query_mask)
        s2, n2 = self.layer_norm2(s1, residual=a)
        return s2, self.mlp(n2)


class _PreNorm(nn.Module):
    def __init__(self, dim, fn, eps, dtype):
        super().__init__()
        self.norm = LayerNorm(dim, eps, dtype)
        self.fn = fn


class _SequentialFeedForward(TensorParallel, nn.Module):
    """The reference fusion MLP: ``net`` = Linear, GELU, Dropout, Linear,
    Dropout (parameters at net.0 and net.3), evaluated in ``dtype``.
    Returns (out, None), as :class:`MoEFeedForward` returns (out, aux).
    Under tp each rank computes its hidden units (the first dropout draws
    on them)."""

    TP_CUT = {"net.0.weight": (0, 1), "net.3.weight": (1, 1)}

    def __init__(self, dim, hidden_dim, dropout, dtype):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), GELU(),
                                 Dropout(dropout), nn.Linear(hidden_dim, dim),
                                 Dropout(dropout))
        self.dtype = dtype

    def tp_partial(self):
        return ["net.0.bias"]

    def forward(self, x):
        net, tp = self.net, self.tp
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        h = net[2](net[1](col_linear(x, net[0].weight, net[0].bias, self.dtype, tp)))
        return net[4](row_linear(h, net[3], self.dtype, tp)), None


class FusionBlock(nn.ModuleList):
    """The same pre-norm block with the reference fusion transformer's names
    (``[PreNorm(Attention), PreNorm(FeedForward)]``), exact GELU, and the
    same ``pending`` wiring. With ``moe_experts`` > 0 the FFN is a
    :class:`MoEFeedForward` (parameters at ``1.fn.{router,w1,b1,w2,b2}``).
    Returns (the block's output, the MoE aux loss or None)."""

    def __init__(self, dim, heads, mlp_dim, dim_head=None, ln_eps=1e-5,
                 dropout=0.0, dtype=torch.float32, moe_experts=0, moe_top_k=1,
                 moe_capacity_factor=1.25):
        if moe_experts > 0:
            ffn = MoEFeedForward(dim, mlp_dim, moe_experts, moe_top_k,
                                 moe_capacity_factor, dropout, dtype)
        else:
            ffn = _SequentialFeedForward(dim, mlp_dim, dropout, dtype)
        super().__init__([
            _PreNorm(dim, MultiHeadAttention(dim, heads, dim_head,
                                             fused_qkv=True, dropout=dropout,
                                             dtype=dtype),
                     ln_eps, dtype),
            _PreNorm(dim, ffn, ln_eps, dtype),
        ])

    def forward(self, x, key_mask=None, *, pending=None,
                legacy_query_mask=None):
        attn, ff = self[0], self[1]
        if pending is None:
            x = x + attn.fn(attn.norm(x), key_mask,
                            legacy_query_mask=legacy_query_mask)
            h, aux = ff.fn(ff.norm(x))
            return x + h, aux
        s1, n1 = attn.norm(x, residual=pending)
        a = attn.fn(n1, key_mask, legacy_query_mask=legacy_query_mask)
        s2, n2 = ff.norm(s1, residual=a)
        h, aux = ff.fn(n2)
        return (s2, h), aux


class PipeStage:
    """A pp stage's share of a pipelined stack: its layers ``[lo, hi)`` of
    the stack, the mesh, and whether the stack trains (the same on every
    stage). Called with the stack's blocks and inputs, it runs them as a
    GPipe pipe; key and query masks ride as per-sample side inputs (a mask
    of batch 1 is broadcast to the batch first: the same math as JAX's
    scan path, which takes such a mask)."""

    def __init__(self, mesh, lo: int, hi: int, trainable: bool):
        self.mesh, self.lo, self.hi, self.trainable = mesh, lo, hi, trainable

    def __call__(self, blocks, x, key_mask, legacy_query_mask, remat):
        from bifold_tpu_torch.parallel.pipeline import gpipe, microbatch_count

        if ln_ops.ln_mode() == "fused":
            raise RuntimeError("a stack placed as a pipe runs outside the "
                               "BIFOLD_LN_KERNEL=fused wiring (JAX's pipe does); "
                               "place the model again under this mode")
        layers = blocks[self.lo:self.hi]
        b = x.shape[0]
        side = [None if m is None else m.expand(b, *m.shape[1:]) if m.shape[0] == 1
                else m for m in (key_mask, legacy_query_mask)]

        def body(h, km, lqm):
            return run_blocks(layers, h, km, lqm, remat=remat)

        params = [p for layer in layers for p in layer.parameters()]
        m = microbatch_count(b, self.mesh.shape["pp"], self.mesh.pp_microbatches)
        return gpipe(body, params, x, mesh=self.mesh, microbatches=m, side=side,
                     trainable=self.trainable)


class PipelineStack:
    """A stack of pre-norm blocks (``BLOCKS`` names its ``ModuleList``)
    that a placement may pipeline: with a :class:`PipeStage` in ``pipe`` it
    runs as one, else through :func:`run_blocks`."""

    pipe = None
    BLOCKS = "layers"

    @property
    def blocks(self) -> nn.ModuleList:
        return getattr(self, self.BLOCKS)

    def has_experts(self) -> bool:
        return any(isinstance(m, MoEFeedForward) for m in self.modules())

    def run(self, x, key_mask=None, legacy_query_mask=None, *, remat=False, aux=None):
        if self.pipe is None:
            return run_blocks(self.blocks, x, key_mask, legacy_query_mask,
                              remat=remat, aux=aux)
        return self.pipe(self.blocks, x, key_mask, legacy_query_mask, remat)


class Transformer(PipelineStack, nn.Module):
    """Stack of ``depth`` pre-norm blocks under ``layers``: HF-named
    :class:`TransformerBlock` (gelu-tanh for the towers, ``activation``
    otherwise) or :class:`FusionBlock` (exact gelu) for the fusion stack
    (``fused_qkv``, with ``dropout`` and the MoE options); the towers take
    ``lora_dropout`` on their adapters. Under ``BIFOLD_LN_KERNEL=fused`` the
    stack carries (x, zeros) through the blocks' ``pending`` wiring and
    returns s + pending, as bifold_tpu/models/layers.py:687-693 and 747-750
    do; the state dict is the same either way. ``remat`` recomputes each
    block in the backward (:func:`run_blocks`). ``forward(..., aux=list)``
    appends each MoE block's load-balance loss to the list."""

    def __init__(self, dim, depth, heads, mlp_dim, dim_head=None,
                 fused_qkv=True, lora_rank=0, lora_alpha=1.0, lora_dropout=0.0,
                 dropout=0.0, ln_eps=1e-6, dtype=torch.float32, remat=False,
                 moe_experts=0, moe_top_k=1, moe_capacity_factor=1.25,
                 activation=gelu_tanh):
        super().__init__()
        if fused_qkv:
            blocks = [FusionBlock(dim, heads, mlp_dim, dim_head, ln_eps,
                                  dropout, dtype, moe_experts, moe_top_k,
                                  moe_capacity_factor)
                      for _ in range(depth)]
        else:
            blocks = [TransformerBlock(dim, heads, mlp_dim, dim_head,
                                       lora_rank, lora_alpha, lora_dropout,
                                       ln_eps, dtype, activation)
                      for _ in range(depth)]
        self.layers = nn.ModuleList(blocks)
        self.remat = remat

    def forward(self, x, key_mask=None, *, legacy_query_mask=None, aux=None):
        return self.run(x, key_mask, legacy_query_mask, remat=self.remat, aux=aux)


def _dropout_generators(module: nn.Module):
    """The distinct generators the dropouts of ``module`` draw from."""
    gens = {}
    for mod in module.modules():
        if isinstance(mod, Dropout) and mod.generator is not None:
            gens[id(mod.generator)] = mod.generator
    return list(gens.values())


def _replay_dropout(gens):
    """``context_fn`` for :func:`torch.utils.checkpoint.checkpoint`: the
    forward records the generators' states, and the recompute in the
    backward draws from those states (so it draws the forward's masks) and
    leaves the generators as it found them. torch's own RNG-state
    preservation covers only its default generators, and the port's
    dropouts never draw from those."""
    states = []

    @contextlib.contextmanager
    def forward():
        states[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, states):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return forward(), recompute()


def _call_block(block, carry, key_mask, legacy_query_mask, remat):
    """One block on ``carry`` (x, or (x, pending) under the fused wiring)
    -> (carry, MoE aux or None); under ``remat`` (and autograd) inside
    :func:`torch.utils.checkpoint.checkpoint`, the block's dropout draws
    replayed in the recompute. A block that a placement gave its share of
    the fsdp units (``block.fsdp``,
    :class:`~bifold_tpu_torch.parallel.sharding.Placement`) runs on its
    whole tensors gathered just before it and dropped just after
    (``torch.func.functional_call``); the recompute gathers them again, and
    without ``remat`` the backward gathers each saved one again."""
    share = getattr(block, "fsdp", None)

    def run(*carry):
        pending = carry[1] if len(carry) == 2 else None
        kwargs = {"pending": pending, "legacy_query_mask": legacy_query_mask}
        if share is None:
            out = block(carry[0], key_mask, **kwargs)
        else:
            with share.weights() as tensors:
                out = torch.func.functional_call(block, tensors, (carry[0], key_mask),
                                                 kwargs, strict=False)
        return out if isinstance(block, FusionBlock) else (out, None)

    carry = carry if isinstance(carry, tuple) else (carry,)
    if remat and torch.is_grad_enabled():
        gens = _dropout_generators(block)
        return checkpoint(run, *carry, use_reentrant=False,
                          context_fn=lambda: _replay_dropout(gens))
    with share.saving() if share is not None else contextlib.nullcontext():
        return run(*carry)


def run_blocks(blocks, x, key_mask=None, legacy_query_mask=None, *,
               remat=False, aux=None):
    """x through a stack of pre-norm blocks; under ``BIFOLD_LN_KERNEL=fused``
    through their ``pending`` wiring, from (x, zeros), ending in s +
    pending. ``remat``: each block recomputed in the backward instead of
    keeping its activations (JAX's ``nn.remat`` per block,
    bifold_tpu/models/layers.py:473-504). MoE blocks' load-balance losses
    are appended to ``aux`` (a list) in block order."""
    fused = ln_ops.ln_mode() == "fused"
    carry = (x, torch.zeros_like(x)) if fused else x
    for block in blocks:
        carry, loss = _call_block(block, carry, key_mask, legacy_query_mask,
                                  remat)
        if loss is not None and aux is not None:
            aux.append(loss)
    return carry[0] + carry[1] if fused else carry


class _ClipAttention(TensorParallel, nn.Module):
    """OpenAI CLIP's ``nn.MultiheadAttention`` parameters (``in_proj_weight``
    (3D, D) and ``in_proj_bias`` (3D,) with q, k, v stacked, ``out_proj``)
    computed as the JAX package's separate q/k/v Dense layers are: each
    projection in ``dtype``, then :func:`dot_product_attention` (causal in
    the text tower). Under tp each rank holds its heads' rows of q, of k
    and of v."""

    TP_CUT = {"in_proj_weight": (0, 3), "out_proj.weight": (1, 1)}

    def __init__(self, dim, heads, causal, dtype):
        super().__init__()
        self.heads = heads
        self.dim_head = dim // heads
        self.causal = causal
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def tp_partial(self):
        return ["in_proj_bias"]

    def forward(self, x, key_mask=None, *, legacy_query_mask=None):
        b, n, _ = x.shape
        tp = self.tp
        heads = self.heads // tp.size if tp is not None else self.heads
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        qkv = col_linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype, tp, 3)
        shape = (b, n, heads, self.dim_head)
        q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, key_mask, causal=self.causal,
                                    legacy_query_mask=legacy_query_mask)
        return row_linear(out.reshape(b, n, heads * self.dim_head), self.out_proj,
                          self.dtype, tp)


class _ClipMLP(TensorParallel, nn.Module):
    TP_CUT = {"c_fc.weight": (0, 1), "c_proj.weight": (1, 1)}

    def __init__(self, dim, hidden_dim, dtype):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, dim)
        self.dtype = dtype

    def tp_partial(self):
        return ["c_fc.bias"]

    def forward(self, x):
        tp = self.tp
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        h = col_linear(x, self.c_fc.weight, self.c_fc.bias, self.dtype, tp)
        return row_linear(quick_gelu(h), self.c_proj, self.dtype, tp)


class ClipResidualBlock(nn.Module):
    """OpenAI CLIP's ``ResidualAttentionBlock`` (``ln_1``, ``attn``,
    ``ln_2``, ``mlp.c_fc`` / ``mlp.c_proj``): the pre-norm block of
    :class:`TransformerBlock` with QuickGELU, LayerNorm eps 1e-5 and the
    same ``pending`` wiring (bifold_tpu/models/layers.py:372-440 as the
    CLIP towers configure it)."""

    def __init__(self, dim, heads, mlp_dim, causal=False, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(dim, 1e-5, dtype)
        self.attn = _ClipAttention(dim, heads, causal, dtype)
        self.ln_2 = LayerNorm(dim, 1e-5, dtype)
        self.mlp = _ClipMLP(dim, mlp_dim, dtype)

    def forward(self, x, key_mask=None, *, pending=None,
                legacy_query_mask=None):
        if pending is None:
            x = x + self.attn(self.ln_1(x), key_mask,
                              legacy_query_mask=legacy_query_mask)
            return x + self.mlp(self.ln_2(x))
        s1, n1 = self.ln_1(x, residual=pending)
        a = self.attn(n1, key_mask, legacy_query_mask=legacy_query_mask)
        s2, n2 = self.ln_2(s1, residual=a)
        return s2, self.mlp(n2)


class ClipTransformer(PipelineStack, nn.Module):
    """``depth`` :class:`ClipResidualBlock` under ``resblocks`` (CLIP's
    ``Transformer``), run as :class:`Transformer` runs its stack."""

    BLOCKS = "resblocks"

    def __init__(self, dim, depth, heads, causal=False, dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ClipResidualBlock(dim, heads, 4 * dim, causal, dtype)
            for _ in range(depth))

    def forward(self, x, key_mask=None):
        return self.run(x, key_mask)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """Frozen 2-D sin-cos position embedding (MAE's; the JAX package's
    bifold_tpu/models/layers.py:780-799): (P[+1], D) float32 numpy, the
    first half of the channels for the w coordinate, the second for h, a
    zero row first with ``cls_token``."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")

    def one_dim(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)     # w first
    emb = np.concatenate([one_dim(embed_dim // 2, grid[0]),
                          one_dim(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)
