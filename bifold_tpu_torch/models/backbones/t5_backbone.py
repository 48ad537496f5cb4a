"""T5 text encoder of the port (the non-CLIP branch of ``text_unet``).

Counterpart of bifold_tpu/models/backbones/t5_backbone.py: the same
configurations (``T5Config``, ``T5_CONFIGS`` :55, ``resolve_t5_config`` :72
with its ``ValueError``s), the same relative-position buckets (:115) and
the same encoder (:135), with Hugging Face ``T5EncoderModel``'s parameter
names, so that an HF state dict (and ``convert_t5_inverse``'s) loads with
``strict=True``:

- ``shared`` (the token table; the same module is also registered as
  ``encoder.embed_tokens``, so a state dict's two tied copies fill one
  tensor);
- ``encoder.block.<i>.layer.0.SelfAttention.{q,k,v,o}`` (bias-free),
  ``...relative_attention_bias`` on block 0 only (one (buckets, heads)
  table shared by every layer), ``encoder.block.<i>.layer.0.layer_norm``;
- ``encoder.block.<i>.layer.1.DenseReluDense.{wi | wi_0, wi_1, wo}`` and
  ``...layer.1.layer_norm``; ``encoder.final_layer_norm``.

The arithmetic follows the JAX module's rounding points: RMS norm with its
variance in float32 (flax ``RMSNorm``: ``x * (rsqrt(mean(x^2) + eps) *
scale)`` in float32, cast to the model dtype); no 1/sqrt(d_kv) scaling;
scores in the model dtype, cast to float32 before the position bias, the
softmax in float32 and the probabilities cast back before the PV product;
the gated FFN's tanh-approximated GELU. Dropout (the config's
``dropout_rate``) acts where JAX's does: on the embedding, the
probabilities, both residual branches, the FFN hidden values and the
output, through the port's generator-driven :class:`Dropout`. The encoder
attends to every token, padding included, as the reference calls it
without a mask.

The bucket ids are computed on the host in float32 with JAX's arithmetic
(``log`` over a Python-float denominator, truncated to int32) and then
moved to the model's device, so the card uses the CPU's ids.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import torch
from torch import nn
from torch.nn import functional as F

from bifold_tpu_torch.models.dropout import Dropout

__all__ = ["T5Config", "T5Encoder", "T5_CONFIGS", "resolve_t5_config"]


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"


T5_CONFIGS = {
    "t5-small": T5Config(),
    "t5-base": T5Config(d_model=768, d_ff=3072, num_layers=12, num_heads=12),
    "t5-large": T5Config(d_model=1024, d_ff=4096, num_layers=24, num_heads=16),
    "google/flan-t5-small": T5Config(d_model=512, d_kv=64, d_ff=1024, num_layers=8,
                                     num_heads=6, feed_forward_proj="gated-gelu"),
    "google/flan-t5-base": T5Config(d_model=768, d_ff=2048, num_layers=12,
                                    num_heads=12, feed_forward_proj="gated-gelu"),
    "google/flan-t5-large": T5Config(d_model=1024, d_kv=64, d_ff=2816, num_layers=24,
                                     num_heads=16, feed_forward_proj="gated-gelu"),
}


def _unknown(name_or_dir) -> ValueError:
    return ValueError(
        f"text_encoder {name_or_dir!r} is neither a CLIP model, a known T5 "
        f"config ({sorted(T5_CONFIGS)}), nor a local T5 checkpoint directory "
        "with a config.json")


def resolve_t5_config(name_or_dir: str) -> T5Config:
    """A registry name or a local HF checkpoint dir -> :class:`T5Config`;
    ``ValueError`` for anything else (a null or empty name included), and
    for a dir whose ``config.json`` is not a T5 model's."""
    if name_or_dir in T5_CONFIGS:
        return T5_CONFIGS[name_or_dir]
    if not isinstance(name_or_dir, str) or not name_or_dir:
        raise _unknown(name_or_dir)
    cfg_path = Path(name_or_dir) / "config.json"
    if not cfg_path.is_file():
        raise _unknown(name_or_dir)
    raw = json.loads(cfg_path.read_text())
    if raw.get("model_type") != "t5":
        raise ValueError(f"{name_or_dir}/config.json has model_type="
                         f"{raw.get('model_type')!r}; expected 't5'")
    ff = raw.get("feed_forward_proj", "relu")
    if raw.get("is_gated_act") or ff.startswith("gated"):
        ff = "gated-gelu"
    return T5Config(
        vocab_size=raw["vocab_size"], d_model=raw["d_model"],
        d_kv=raw.get("d_kv", 64), d_ff=raw["d_ff"], num_layers=raw["num_layers"],
        num_heads=raw["num_heads"],
        relative_attention_num_buckets=raw.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=raw.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=raw.get("layer_norm_epsilon", 1e-6),
        dropout_rate=raw.get("dropout_rate", 0.1), feed_forward_proj=ff)


def _relative_position_bucket(relative_position: torch.Tensor, *, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket`` (bidirectional) with the
    JAX package's arithmetic: int32 offsets (memory - query) in, int32
    buckets out; half the buckets for the sign, half of the rest exact small
    offsets, the others log-spaced up to ``max_distance``."""
    num_buckets //= 2
    buckets = torch.where(relative_position > 0, num_buckets, 0).to(torch.int32)
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    relf = rel.clamp_min(1).to(torch.float32)
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (torch.log(relf / max_exact) / denom
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp_max(num_buckets - 1)
    return buckets + torch.where(rel < max_exact, rel, large).to(torch.int32)


@lru_cache(maxsize=8)
def _bucket_table(n: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(n, n) int64 bucket ids of a length-n sequence, on the CPU."""
    pos = torch.arange(n, dtype=torch.int32)
    return _relative_position_bucket(pos[None, :] - pos[:, None],
                                     num_buckets=num_buckets,
                                     max_distance=max_distance).long()


class T5LayerNorm(nn.Module):
    """flax ``RMSNorm`` (scale only): float32 statistics, cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.weight.float())).to(self.dtype)


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, dtype):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.heads, self.d_kv, self.dtype = cfg.num_heads, cfg.d_kv, dtype
        self.attn_dropout = Dropout(cfg.dropout_rate)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, position_bias):
        att, dt = self.SelfAttention, self.dtype
        h = self.layer_norm(x)
        b, n, _ = h.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = (split(_linear(h, lin, dt)) for lin in (att.q, att.k, att.v))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() + position_bias
        probs = self.attn_dropout(torch.softmax(scores, dim=-1).to(dt))
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, -1)
        return x + self.dropout(_linear(out, att.o, dt))


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, dtype):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.dtype = dtype
        self.hidden_dropout = Dropout(cfg.dropout_rate)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x):
        ff, dt = self.DenseReluDense, self.dtype
        h = self.layer_norm(x)
        if ff.gated:
            h = F.gelu(_linear(h, ff.wi_0, dt), approximate="tanh") * _linear(h, ff.wi_1, dt)
        else:
            h = torch.relu(_linear(h, ff.wi, dt))
        return x + self.dropout(_linear(self.hidden_dropout(h), ff.wo, dt))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, dtype):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias, dtype),
                                    T5LayerFF(cfg, dtype)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, shared: nn.Embedding, dtype):
        super().__init__()
        self.embed_tokens = shared
        self.block = nn.ModuleList(T5Block(cfg, i == 0, dtype)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)


class T5Encoder(nn.Module):
    """(B, N) int ids -> (B, N, d_model) last hidden states in ``dtype``."""

    def __init__(self, cfg: T5Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg, self.shared, dtype)
        self.embed_dropout = Dropout(cfg.dropout_rate)
        self.dropout = Dropout(cfg.dropout_rate)

    def position_bias(self, n: int) -> torch.Tensor:
        """(1, heads, n, n) float32 bias from block 0's table."""
        cfg = self.cfg
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        ids = _bucket_table(n, cfg.relative_attention_num_buckets,
                            cfg.relative_attention_max_distance).to(table.device)
        return F.embedding(ids, table.float()).permute(2, 0, 1)[None]

    def forward(self, input_ids):
        x = self.embed_dropout(F.embedding(input_ids.long(), self.shared.weight)
                               .to(self.dtype))
        bias = self.position_bias(input_ids.shape[1])
        for block in self.encoder.block:
            x = block(x, bias)
        return self.dropout(self.encoder.final_layer_norm(x))
