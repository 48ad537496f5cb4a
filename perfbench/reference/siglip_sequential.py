"""Plain reference of BiFold's ``siglip_sequential`` (arXiv 2501.16458).

SigLIP B/16 towers (HF ``SiglipVisionModel`` / ``SiglipTextModel``: patch
conv, learned positions, pre-LN layers with gelu-tanh MLPs, LayerNorm eps
1e-6, ``post_layernorm`` / ``final_layer_norm``; no text padding mask) with
peft LoRA on q and v; the current frame and the context frames through the
vision tower; a learned image token before each frame's patches and a text
token before the text; learned context positions; the BiFold concat fusion
over [text | context | current] with the context frames' tokens masked as
keys where the frame is padding; the current frame's patch tokens to four
conv decoder heads (left/right pick/place). Weights are the flat dict ``W``
of checkpoint names.

Dropout: the only nonzero rate is LoRA's (``lora_dropout``) on the q and v
adapters' input. :class:`LoraDropout` draws its keep masks as the card's
``torch.rand`` would from one generator seeded per step, in the order the
layers run (vision layers 0..L-1, q then v, then the text layers), each mask
over the whole batch, so a reference run in row blocks sees the masks of
one whole-batch pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ref_common import Prec, concat_fusion, conv_decoder, layer_norm, siglip_block

HEADS = ("left_pick", "right_pick", "left_place", "right_place")


def dims(cfg):
    m, t = cfg["model"], cfg["towers"]
    p = m["patch_size"]
    return dict(s=m["image_size"], p=p, w=m["dim"], n=(m["image_size"] // p) ** 2,
                layers=t["layers"], heads=t["heads"], mlp=t["mlp"], vocab=t["vocab"],
                text=t["text_tokens"], eps=t["ln_eps"], r=m["r"],
                scaling=m["lora_alpha"] / m["r"], depth=m["depth"], fheads=m["heads"],
                fmlp=m["dim"] * m["mlp_ratio"], ctx=m["context_length"])


def param_shapes(cfg) -> dict:
    """Every parameter's name and shape, in checkpoint order."""
    d = dims(cfg)
    w, r = d["w"], d["r"]
    out = {"image_token": (1, 1, w), "text_token": (1, 1, w),
           "context_pos_embedding": (1, d["ctx"] * (d["n"] + 1), w)}

    def tower(pre, emb):
        out.update(emb)
        for i in range(d["layers"]):
            p = f"{pre}.encoder.layers.{i}"
            out[p + ".layer_norm1.weight"] = out[p + ".layer_norm1.bias"] = (w,)
            for proj in ("q_proj", "k_proj", "v_proj"):
                base = f"{p}.self_attn.{proj}" + (".base_layer" if proj != "k_proj" else "")
                out[base + ".weight"], out[base + ".bias"] = (w, w), (w,)
                if proj != "k_proj":
                    out[f"{p}.self_attn.{proj}.lora_A.siglip_adapter.weight"] = (r, w)
                    out[f"{p}.self_attn.{proj}.lora_B.siglip_adapter.weight"] = (w, r)
            out[p + ".self_attn.out_proj.weight"], out[p + ".self_attn.out_proj.bias"] = (w, w), (w,)
            out[p + ".layer_norm2.weight"] = out[p + ".layer_norm2.bias"] = (w,)
            out[p + ".mlp.fc1.weight"], out[p + ".mlp.fc1.bias"] = (d["mlp"], w), (d["mlp"],)
            out[p + ".mlp.fc2.weight"], out[p + ".mlp.fc2.bias"] = (w, d["mlp"]), (w,)

    v = "siglip_model.model.vision_model"
    tower(v, {v + ".embeddings.patch_embedding.weight": (w, 3, d["p"], d["p"]),
              v + ".embeddings.patch_embedding.bias": (w,),
              v + ".embeddings.position_embedding.weight": (d["n"], w)})
    out[v + ".post_layernorm.weight"] = out[v + ".post_layernorm.bias"] = (w,)
    t = "siglip_model.model.text_model"
    tower(t, {t + ".embeddings.token_embedding.weight": (d["vocab"], w),
              t + ".embeddings.position_embedding.weight": (d["text"], w)})
    out[t + ".final_layer_norm.weight"] = out[t + ".final_layer_norm.bias"] = (w,)
    f = "pick_place.fusion"
    out[f + ".token_type_embeddings.weight"] = (2, w)
    for i in range(d["depth"]):
        p = f"{f}.transformer_encoder.layers.{i}"
        out[p + ".0.norm.weight"] = out[p + ".0.norm.bias"] = (w,)
        out[p + ".0.fn.to_qkv.weight"] = (3 * w, w)
        out[p + ".0.fn.to_out.0.weight"], out[p + ".0.fn.to_out.0.bias"] = (w, w), (w,)
        out[p + ".1.norm.weight"] = out[p + ".1.norm.bias"] = (w,)
        out[p + ".1.fn.net.0.weight"], out[p + ".1.fn.net.0.bias"] = (d["fmlp"], w), (d["fmlp"],)
        out[p + ".1.fn.net.3.weight"], out[p + ".1.fn.net.3.bias"] = (w, d["fmlp"]), (w,)
    chans = [w, w // 2, w // 2, w // 4, w // 4, 1]
    for head in HEADS:
        for j, i in enumerate((0, 2, 4, 6, 8)):
            p = f"pick_place.{head}_decoder.decoder_net.{i}"
            out[p + ".weight"], out[p + ".bias"] = (chans[j + 1], chans[j], 1, 1), (chans[j + 1],)
    return out


def trainable(name: str) -> bool:
    """The towers are frozen but their LoRA adapters."""
    return not name.startswith("siglip_model.") or ".lora_" in name


class LoraDropout:
    """The LoRA adapters' dropout masks of one train step (module doc)."""

    def __init__(self, cfg, batch: int, seed: int, device, rows=None):
        d = dims(cfg)
        self.keep = 1.0 - float(cfg["model"]["lora_dropout"])
        gen = torch.Generator(device=device).manual_seed(seed)
        frames = batch * (d["ctx"] + 1)
        self.masks = []
        for shape in ((frames, d["n"], d["w"]), (batch, d["text"], d["w"])):
            for _ in range(2 * d["layers"]):
                self.masks.append(torch.rand(shape, generator=gen, device=device) < self.keep)
        self.per_row = [d["ctx"] + 1] * (2 * d["layers"]) + [1] * (2 * d["layers"])
        self.rows = rows
        self.i = 0

    def next(self):
        mask, per = self.masks[self.i], self.per_row[self.i]
        self.i += 1
        if self.rows is not None:
            mask = mask[self.rows[0] * per: self.rows[1] * per]
        return lambda x: torch.where(mask, x / self.keep, torch.zeros((), device=x.device))


def forward(W, cfg, sample, prec: Prec, drops=None) -> dict:
    """Logits of the four heads, (B, S, S) each, from the model inputs."""
    d = dims(cfg)
    w, n = d["w"], d["n"]
    rgb, ctx = sample["rgb"], sample["rgb_context"]
    b, t = ctx.shape[0], ctx.shape[1]
    frames = torch.cat([rgb[:, None], ctx], dim=1).reshape(b * (t + 1), *ctx.shape[2:])
    v = "siglip_model.model.vision_model"
    x = F.conv2d(prec.q(frames), prec.q(W[v + ".embeddings.patch_embedding.weight"]),
                 W[v + ".embeddings.patch_embedding.bias"].float(), stride=d["p"])
    x = x.flatten(2).transpose(1, 2) + W[v + ".embeddings.position_embedding.weight"].float()[None]
    for i in range(d["layers"]):
        x = siglip_block(x, W, f"{v}.encoder.layers.{i}", d["heads"], d["eps"], prec,
                         d["scaling"], drops)
    feats = layer_norm(x, W, v + ".post_layernorm", d["eps"]).reshape(b, t + 1, n, w)
    tx = "siglip_model.model.text_model"
    ids = sample["instruction"].long()
    y = (W[tx + ".embeddings.token_embedding.weight"].float()[ids]
         + W[tx + ".embeddings.position_embedding.weight"].float()[: ids.shape[1]][None])
    for i in range(d["layers"]):
        y = siglip_block(y, W, f"{tx}.encoder.layers.{i}", d["heads"], d["eps"], prec,
                         d["scaling"], drops)
    text = layer_norm(y, W, tx + ".final_layer_norm", d["eps"])
    img_tok = W["image_token"].float()
    text = torch.cat([W["text_token"].float().expand(b, 1, w), text], dim=1)
    image = torch.cat([img_tok.expand(b, 1, w), feats[:, 0]], dim=1)
    context = torch.cat([img_tok.expand(b, t, 1, w), feats[:, 1:]],
                        dim=2).reshape(b, t * (n + 1), w)
    context = context + W["context_pos_embedding"].float()[:, : t * (n + 1)]
    in_frame = sample["context_attention_mask"].to(torch.int32)
    key_mask = torch.cat([torch.ones((b, text.shape[1]), dtype=torch.int32, device=rgb.device),
                          in_frame.repeat_interleave(n + 1, dim=1),
                          torch.ones((b, n + 1), dtype=torch.int32, device=rgb.device)], dim=1)
    fused = concat_fusion(W, "pick_place.fusion", [text, context, image], [0, 1, 1],
                          d["depth"], d["fheads"], prec, key_mask)
    side = int(n ** 0.5)
    grid = fused[:, 1:].reshape(b, side, side, w)
    return {h: conv_decoder(W, f"pick_place.{h}_decoder", grid, prec) for h in HEADS}
