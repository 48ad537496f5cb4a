"""Plain reference of BiFold's ``rgb_clip`` baseline (CLIP, arXiv
2103.00020, OpenAI ViT-B/16 names).

The frozen CLIP vision tower (bias-free patch conv, class token, learned
positions, ``ln_pre``, residual blocks with fused q/k/v in-projection and
QuickGELU, LayerNorm eps 1e-5, ``ln_post``: every token) and text tower
(token and position embeddings, causal blocks, ``ln_final``: every token);
the image tokens projected to the text width plus learned positions; a text
token before the text tokens plus learned positions; the BiFold concat
fusion over [text | image] with no mask; the image's patch tokens to the
pick and place conv decoders. No dropout is active (every rate is 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ref_common import (Prec, attention, concat_fusion, conv_decoder, layer_norm,
                    quick_gelu)

HEADS = ("pick", "place")


def dims(cfg):
    m, t = cfg["model"], cfg["towers"]
    return dict(s=m["image_size"], p=m["patch_size"], n=(m["image_size"] // m["patch_size"]) ** 2,
                vw=t["vision_width"], vl=t["vision_layers"], vh=t["vision_heads"],
                tw=t["text_width"], tl=t["text_layers"], th=t["text_heads"],
                text=t["text_tokens"], vocab=t["vocab"], embed=t["embed_dim"],
                depth=m["depth"], fheads=m["heads"], fmlp=t["text_width"] * m["mlp_ratio"])


def param_shapes(cfg) -> dict:
    d = dims(cfg)
    out = {}

    def blocks(pre, w, layers):
        for i in range(layers):
            p = f"{pre}.resblocks.{i}"
            out[p + ".ln_1.weight"] = out[p + ".ln_1.bias"] = (w,)
            out[p + ".attn.in_proj_weight"], out[p + ".attn.in_proj_bias"] = (3 * w, w), (3 * w,)
            out[p + ".attn.out_proj.weight"], out[p + ".attn.out_proj.bias"] = (w, w), (w,)
            out[p + ".ln_2.weight"] = out[p + ".ln_2.bias"] = (w,)
            out[p + ".mlp.c_fc.weight"], out[p + ".mlp.c_fc.bias"] = (4 * w, w), (4 * w,)
            out[p + ".mlp.c_proj.weight"], out[p + ".mlp.c_proj.bias"] = (w, 4 * w), (w,)

    vw, tw = d["vw"], d["tw"]
    out["rgb_pos_embedding"] = (1, d["n"] + 1, tw)
    out["text_token"] = (1, 1, tw)
    out["text_pos_embedding"] = (1, d["text"] + 1, tw)
    v = "clip_encoder.visual"
    out[v + ".class_embedding"] = (vw,)
    out[v + ".positional_embedding"] = (d["n"] + 1, vw)
    out[v + ".conv1.weight"] = (vw, 3, d["p"], d["p"])
    out[v + ".ln_pre.weight"] = out[v + ".ln_pre.bias"] = (vw,)
    blocks(v + ".transformer", vw, d["vl"])
    out[v + ".ln_post.weight"] = out[v + ".ln_post.bias"] = (vw,)
    c = "clip_encoder"
    out[c + ".positional_embedding"] = (d["text"], tw)
    out[c + ".text_projection"] = (tw, d["embed"])
    out[c + ".token_embedding.weight"] = (d["vocab"], tw)
    blocks(c + ".transformer", tw, d["tl"])
    out[c + ".ln_final.weight"] = out[c + ".ln_final.bias"] = (tw,)
    out["project.weight"], out["project.bias"] = (tw, vw), (tw,)
    f = "pick_place.fusion"
    out[f + ".token_type_embeddings.weight"] = (2, tw)
    for i in range(d["depth"]):
        p = f"{f}.transformer_encoder.layers.{i}"
        out[p + ".0.norm.weight"] = out[p + ".0.norm.bias"] = (tw,)
        out[p + ".0.fn.to_qkv.weight"] = (3 * tw, tw)
        out[p + ".0.fn.to_out.0.weight"], out[p + ".0.fn.to_out.0.bias"] = (tw, tw), (tw,)
        out[p + ".1.norm.weight"] = out[p + ".1.norm.bias"] = (tw,)
        out[p + ".1.fn.net.0.weight"], out[p + ".1.fn.net.0.bias"] = (d["fmlp"], tw), (d["fmlp"],)
        out[p + ".1.fn.net.3.weight"], out[p + ".1.fn.net.3.bias"] = (tw, d["fmlp"]), (tw,)
    chans = [tw, tw // 2, tw // 2, tw // 4, tw // 4, 1]
    for head in HEADS:
        for j, i in enumerate((0, 2, 4, 6, 8)):
            p = f"pick_place.{head}_decoder.decoder_net.{i}"
            out[p + ".weight"], out[p + ".bias"] = (chans[j + 1], chans[j], 1, 1), (chans[j + 1],)
    return out


def trainable(name: str) -> bool:
    return not name.startswith("clip_encoder.")


def clip_block(x, W, p, heads, prec, causal):
    b, n, w = x.shape
    h = layer_norm(x, W, p + ".ln_1", 1e-5)
    q, k, v = prec.linear(h, W[p + ".attn.in_proj_weight"], W[p + ".attn.in_proj_bias"]).chunk(3, -1)
    shape = (b, n, heads, w // heads)
    o = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), prec, causal=causal)
    x = x + prec.linear(o.reshape(b, n, w), W[p + ".attn.out_proj.weight"],
                        W[p + ".attn.out_proj.bias"])
    h = quick_gelu(prec.linear(layer_norm(x, W, p + ".ln_2", 1e-5),
                               W[p + ".mlp.c_fc.weight"], W[p + ".mlp.c_fc.bias"]))
    return x + prec.linear(h, W[p + ".mlp.c_proj.weight"], W[p + ".mlp.c_proj.bias"])


def forward(W, cfg, sample, prec: Prec, drops=None) -> dict:
    d = dims(cfg)
    rgb = sample["rgb"]
    b = rgb.shape[0]
    v = "clip_encoder.visual"
    with torch.no_grad():            # frozen towers: no gradient reaches them
        x = F.conv2d(prec.q(rgb), prec.q(W[v + ".conv1.weight"]), stride=d["p"])
        x = x.flatten(2).transpose(1, 2)
        cls = W[v + ".class_embedding"].float().expand(b, 1, d["vw"])
        x = torch.cat([cls, x], dim=1) + W[v + ".positional_embedding"].float()
        x = layer_norm(x, W, v + ".ln_pre", 1e-5)
        for i in range(d["vl"]):
            x = clip_block(x, W, f"{v}.transformer.resblocks.{i}", d["vh"], prec, False)
        image = layer_norm(x, W, v + ".ln_post", 1e-5)
        ids = sample["instruction"].long()
        y = W["clip_encoder.token_embedding.weight"].float()[ids]
        y = y + W["clip_encoder.positional_embedding"].float()[: ids.shape[1]]
        for i in range(d["tl"]):
            y = clip_block(y, W, f"clip_encoder.transformer.resblocks.{i}", d["th"], prec, True)
        text = layer_norm(y, W, "clip_encoder.ln_final", 1e-5)
    x_rgb = prec.linear(image, W["project.weight"], W["project.bias"]) + W["rgb_pos_embedding"].float()
    x_text = torch.cat([W["text_token"].float().expand(b, 1, d["tw"]), text], dim=1)
    x_text = x_text + W["text_pos_embedding"].float()[:, : x_text.shape[1]]
    fused = concat_fusion(W, "pick_place.fusion", [x_text, x_rgb], [0, 1], d["depth"],
                          d["fheads"], prec)
    side = int(d["n"] ** 0.5)
    grid = fused[:, 1:].reshape(b, side, side, d["tw"])
    return {h: conv_decoder(W, f"pick_place.{h}_decoder", grid, prec) for h in HEADS}
