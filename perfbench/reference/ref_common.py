"""Plain PyTorch building blocks of the reference models.

Every function takes its weights from a flat dict ``W`` keyed by the
published checkpoint names (HF SigLIP, peft LoRA, OpenAI CLIP, the BiFold
fusion and decoders) and computes in float32, with TF32 off on the card
(:func:`float32_matmuls`). ``Prec`` is the precision of the matrix products:
``"float32"``, or ``"fp8"`` for the control, which rounds both operands of
every product (projections, attention scores and values, decoders) to
float8 e4m3 with one scale per tensor before an f32 product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -100000.0   # masked attention logits, as the published fusion fills them


def float32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the product sees it."""
        x = x.float()
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())   # rounded forward, straight-through grad

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def layer_norm(x, W, prefix, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), W[prefix + ".weight"].float(),
                        W[prefix + ".bias"].float(), eps)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, prec: Prec, key_mask=None, causal=False):
    """(B, N, H, D) attention, softmax(q k^T / sqrt(D)) v, masked keys'
    logits set to -1e5; ``key_mask`` (B, N) with 0 for a masked key."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    logits = prec.matmul(qh, kh.transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(key_mask[:, None, None, :] == 0, NEG)
    if causal:
        n = logits.shape[-1]
        tri = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, NEG)
    probs = torch.softmax(logits, dim=-1)
    return prec.matmul(probs, vh).permute(0, 2, 1, 3)


def lora_proj(x, W, prefix, prec, scaling, drop):
    """peft LoRA: base(x) + B(A(dropout(x))) * alpha / r."""
    base = prec.linear(x, W[prefix + ".base_layer.weight"], W[prefix + ".base_layer.bias"])
    a = W[prefix + ".lora_A.siglip_adapter.weight"]
    b = W[prefix + ".lora_B.siglip_adapter.weight"]
    xd = drop(x) if drop is not None else x
    return base + prec.linear(prec.linear(xd, a), b) * scaling


def siglip_block(x, W, p, heads, eps, prec, lora_scaling, drops):
    """HF SigLIP encoder layer with LoRA on q and v; ``drops`` gives the
    dropout of the q and v adapters' input (None in eval)."""
    b, n, w = x.shape
    h = layer_norm(x, W, p + ".layer_norm1", eps)
    a = p + ".self_attn."
    q = lora_proj(h, W, a + "q_proj", prec, lora_scaling, drops and drops.next())
    k = prec.linear(h, W[a + "k_proj.weight"], W[a + "k_proj.bias"])
    v = lora_proj(h, W, a + "v_proj", prec, lora_scaling, drops and drops.next())
    shape = (b, n, heads, w // heads)
    o = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), prec)
    x = x + prec.linear(o.reshape(b, n, w), W[a + "out_proj.weight"], W[a + "out_proj.bias"])
    h = layer_norm(x, W, p + ".layer_norm2", eps)
    h = gelu_tanh(prec.linear(h, W[p + ".mlp.fc1.weight"], W[p + ".mlp.fc1.bias"]))
    return x + prec.linear(h, W[p + ".mlp.fc2.weight"], W[p + ".mlp.fc2.bias"])


def fusion_block(x, W, p, heads, prec, key_mask):
    """The BiFold concat-fusion layer: [PreNorm(Attention), PreNorm(FFN)],
    bias-free fused qkv, exact GELU, LayerNorm eps 1e-5."""
    b, n, w = x.shape
    h = layer_norm(x, W, p + ".0.norm", 1e-5)
    q, k, v = prec.linear(h, W[p + ".0.fn.to_qkv.weight"]).chunk(3, dim=-1)
    shape = (b, n, heads, w // heads)
    o = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), prec, key_mask)
    x = x + prec.linear(o.reshape(b, n, w), W[p + ".0.fn.to_out.0.weight"],
                        W[p + ".0.fn.to_out.0.bias"])
    h = layer_norm(x, W, p + ".1.norm", 1e-5)
    h = gelu_exact(prec.linear(h, W[p + ".1.fn.net.0.weight"], W[p + ".1.fn.net.0.bias"]))
    return x + prec.linear(h, W[p + ".1.fn.net.3.weight"], W[p + ".1.fn.net.3.bias"])


def concat_fusion(W, p, inputs, modalities, depth, heads, prec, key_mask=None):
    """Token-type embeddings per modality, concatenation, the stack; the
    last input's tokens out."""
    types = W[p + ".token_type_embeddings.weight"].float()
    x = torch.cat([inp.float() + types[m][None, None]
                   for inp, m in zip(inputs, modalities)], dim=1)
    for i in range(depth):
        x = fusion_block(x, W, f"{p}.transformer_encoder.layers.{i}", heads, prec, key_mask)
    return x[:, -inputs[-1].shape[1]:]


def conv_decoder(W, p, grid, prec):
    """The published head: five 1x1 convolutions with a bilinear x2
    upsample between each two, no nonlinearity. ``grid`` (B, h, w, C) ->
    logits (B, 16h, 16w)."""
    x = grid.float().permute(0, 3, 1, 2)
    for j, i in enumerate((0, 2, 4, 6, 8)):
        wt = W[f"{p}.decoder_net.{i}.weight"][:, :, 0, 0]
        x = prec.linear(x.permute(0, 2, 3, 1), wt, W[f"{p}.decoder_net.{i}.bias"]).permute(0, 3, 1, 2)
        if j < 4:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return x[:, 0]
