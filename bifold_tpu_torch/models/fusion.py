"""Cross-modal fusion: the concat transformer and cross-attention.

Counterpart of bifold_tpu/models/fusion.py:28-135. Both add learned
token-type embeddings per modality, kept in the compute dtype.

:class:`ConcatTransformer`: one pre-norm stack over the concatenated
[registers | text | (context) | image] sequence with the attention masks
applied as a key mask (``legacy_query_mask`` for the reference's
query-axis quirk; registers always attend and are attended), and the last
modality's token slice out. LayerNorm eps is torch's 1e-5; ``dropout`` is
the stack's attention and FFN dropout (train mode only); ``moe_experts`` >
0 makes every FFN a Mixture of Experts; ``remat`` recomputes each block in
the backward.

:class:`CrossAttention`: the last modality's tokens query the others'
through one multi-head attention with the semantics of flax's
``nn.MultiHeadDotProductAttention``: DenseGeneral query/key/value kernels
(D, H, Dh) with (H, Dh) biases, out kernel (H, Dh, D), the query divided by
sqrt(Dh), masked logits set to the dtype's lowest value, the softmax in the
model's dtype, dropout on the weights shared across batch and heads. Query
and key lengths differ, so it never takes the flash kernel (JAX does not
either): it is einsum math by shape.
"""

from __future__ import annotations

import inspect
import math

import torch
from torch import nn

from bifold_tpu_torch.models.dropout import Dropout
from bifold_tpu_torch.models.layers import Transformer

__all__ = ["ConcatTransformer", "CrossAttention", "FUSIONS", "build_fusion"]


def _typed(inputs, modalities, type_emb, dtype):
    """Each input in ``dtype`` plus its modality's embedding."""
    if modalities is None:
        modalities = list(range(len(inputs)))
    if len(inputs) != len(modalities):
        raise ValueError("one modality id per input")
    return [inp.to(dtype) + type_emb[mod][None, None]
            for mod, inp in zip(modalities, inputs)]


class ConcatTransformer(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int, mlp_ratio: int = 4,
                 num_modalities: int = 2, legacy_query_mask: bool = False,
                 dropout: float = 0.0, num_registers: int = 0,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.token_type_embeddings = nn.Embedding(num_modalities, dim)
        if num_registers > 0:
            self.registers = nn.Parameter(torch.zeros(num_registers, dim))
        self.num_registers = num_registers
        self.transformer_encoder = Transformer(
            dim, depth, heads, dim * mlp_ratio, dim_head=dim // heads,
            fused_qkv=True, dropout=dropout, ln_eps=1e-5, dtype=dtype,
            remat=remat, moe_experts=moe_experts, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor)
        self.legacy_query_mask = legacy_query_mask
        self.dtype = dtype

    def forward(self, *inputs, modalities=None, attention_masks=None, aux=None):
        """The last modality's fused tokens; MoE load-balance losses are
        appended to ``aux`` (a list), one per layer."""
        # the residual stream stays in the compute dtype
        type_emb = self.token_type_embeddings.weight.to(self.dtype)
        parts = _typed(inputs, modalities, type_emb, self.dtype)
        if self.num_registers:
            b = inputs[0].shape[0]
            parts.insert(0, self.registers.to(self.dtype)[None].expand(
                b, *self.registers.shape))
        x = torch.cat(parts, dim=1)
        key_mask = legacy = None
        if attention_masks is not None:
            if self.num_registers:
                ones = torch.ones((x.shape[0], self.num_registers),
                                  dtype=attention_masks.dtype,
                                  device=attention_masks.device)
                attention_masks = torch.cat([ones, attention_masks], dim=1)
            if self.legacy_query_mask:
                legacy = attention_masks
            else:
                key_mask = attention_masks
        x = self.transformer_encoder(x, key_mask, legacy_query_mask=legacy,
                                     aux=aux)
        return x[:, -inputs[-1].shape[1]:, :]


class _DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``'s parameters, kept in its layout."""

    def __init__(self, kernel_shape, bias_shape):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` with default features:
    ``query``/``key``/``value`` (D -> (H, Dh)) and ``out`` ((H, Dh) -> D),
    every product in ``dtype`` (see the module doc)."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        dh = dim // heads
        for name in ("query", "key", "value"):
            setattr(self, name, _DenseGeneral((dim, heads, dh), (heads, dh)))
        self.out = _DenseGeneral((heads, dh, dim), (dim,))
        self.dropout = Dropout(dropout)
        self.dtype = dtype

    def _project(self, x, dense):
        dt = self.dtype
        return torch.einsum("bnd,dhk->bnhk", x.to(dt), dense.kernel.to(dt)) \
            + dense.bias.to(dt)

    def forward(self, inputs_q, inputs_kv, mask=None):
        """``mask``: (B, 1, 1, Nk) boolean, True where keys are attended."""
        dt = self.dtype
        q = self._project(inputs_q, self.query)
        k = self._project(inputs_kv, self.key)
        v = self._project(inputs_kv, self.value)
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=dt)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        if self.dropout.training and self.dropout.rate > 0:
            w = w * self.dropout(torch.ones((1, 1, *w.shape[-2:]), dtype=dt,
                                            device=w.device))
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bqhd,hdo->bqo", out, self.out.kernel.to(dt)) \
            + self.out.bias.to(dt)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int = 1,
                 dropout: float = 0.0, num_modalities: int = 2,
                 dtype=torch.float32):
        super().__init__()
        # depth is accepted for the config's sake, as in JAX: one layer
        self.token_type_embeddings = nn.Embedding(num_modalities, dim)
        self.cross_attention = MultiHeadDotProductAttention(dim, heads, dropout,
                                                            dtype)
        self.dtype = dtype

    def forward(self, *inputs, modalities=None, attention_masks=None, aux=None):
        """The last modality's tokens after attending to the others';
        ``attention_masks`` over [conditions | queries] masks the condition
        keys. ``aux`` is accepted for the fusions' common call (no MoE)."""
        type_emb = self.token_type_embeddings.weight.to(self.dtype)
        typed = _typed(inputs, modalities, type_emb, self.dtype)
        queries, conditions = typed[-1], torch.cat(typed[:-1], dim=1)
        mask = None
        if attention_masks is not None:
            mask = (attention_masks[:, : conditions.shape[1]] > 0)[:, None, None, :]
        return self.cross_attention(queries, conditions, mask)


FUSIONS = {"concat_transformer": ConcatTransformer, "crossattention": CrossAttention}


def build_fusion(fusion_model: str, dim: int, kwargs: dict, dtype) -> nn.Module:
    """The fusion named ``fusion_model`` at width ``dim``, given those of
    ``kwargs`` its constructor takes (bifold_tpu/models/pickplace.py:26-29:
    the shared fusion options, of which cross-attention takes only heads,
    depth and dropout)."""
    if fusion_model not in FUSIONS:
        raise ValueError(f"unknown fusion_model {fusion_model!r} (have "
                         f"{sorted(FUSIONS)})")
    cls = FUSIONS[fusion_model]
    valid = set(inspect.signature(cls).parameters) - {"dim", "dtype"}
    return cls(dim=dim, dtype=dtype, **{k: v for k, v in kwargs.items() if k in valid})
