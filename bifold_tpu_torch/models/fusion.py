"""Cross-modal fusion: the concat transformer.

Counterpart of bifold_tpu/models/fusion.py:28-91: learned token-type
embeddings per modality, one pre-norm stack over the concatenated
[text | (context) | image] sequence with the attention masks applied as a
key mask (``legacy_query_mask`` for the reference's query-axis quirk), and
the last modality's token slice out. LayerNorm eps is torch's 1e-5;
``dropout`` is the stack's attention and FFN dropout (train mode only).
"""

from __future__ import annotations

import torch
from torch import nn

from bifold_tpu_torch.models.layers import Transformer

__all__ = ["ConcatTransformer"]


class ConcatTransformer(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int, mlp_ratio: int = 4,
                 num_modalities: int = 2, legacy_query_mask: bool = False,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.token_type_embeddings = nn.Embedding(num_modalities, dim)
        self.transformer_encoder = Transformer(
            dim, depth, heads, dim * mlp_ratio, dim_head=dim // heads,
            fused_qkv=True, dropout=dropout, ln_eps=1e-5, dtype=dtype)
        self.legacy_query_mask = legacy_query_mask
        self.dtype = dtype

    def forward(self, *inputs, modalities=None, attention_masks=None):
        if modalities is None:
            modalities = list(range(len(inputs)))
        if len(inputs) != len(modalities):
            raise ValueError("one modality id per input")
        # the residual stream stays in the compute dtype
        type_emb = self.token_type_embeddings.weight.to(self.dtype)
        x = torch.cat([inp.to(self.dtype) + type_emb[mod][None, None]
                       for mod, inp in zip(modalities, inputs)], dim=1)
        key_mask = legacy = None
        if attention_masks is not None:
            if self.legacy_query_mask:
                legacy = attention_masks
            else:
                key_mask = attention_masks
        x = self.transformer_encoder(x, key_mask, legacy_query_mask=legacy)
        return x[:, -inputs[-1].shape[1]:, :]
