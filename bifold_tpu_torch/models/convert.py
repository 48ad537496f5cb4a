"""JAX params tree (as numpy arrays) -> the reference's torch state dict.

The port's own copy of ``convert_bifold_inverse`` and its helpers
(bifold_tpu/models/convert.py:551-737), numpy only, for the SigLIP families
this port serves. The keys it emits are the names the port's modules carry,
so ``model.load_state_dict(convert_bifold_inverse(params), strict=True)``
loads a JAX-trained or JAX-initialised model into the port:

- HF SigLIP towers under ``siglip_model.model.`` when the params carry LoRA
  (peft ``base_layer`` / ``lora_A.<adapter>`` / ``lora_B.<adapter>``), else
  under ``siglip_model.``;
- ``text_token``, ``image_token``, ``context_pos_embedding``;
- the fusion stack as ``pick_place.fusion.transformer_encoder.layers.i.{0,1}``;
- the conv decoder heads at ``decoder_net.{0,2,4,6,8}``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["convert_bifold_inverse"]


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack_blocks(enc: Dict) -> list:
    """Encoder subtree -> per-layer dicts: depth-stacked ``blocks/block``
    (nn.scan layout) or unrolled ``block_i``."""
    if "blocks" in enc:
        stacked = enc["blocks"]["block"]
        depth = int(np.shape(_first_leaf(stacked))[0])
        return [_index_tree(stacked, i) for i in range(depth)]
    keys = sorted((k for k in enc if k.startswith("block_")),
                  key=lambda s: int(s.split("_")[1]))
    return [enc[k] for k in keys]


def _inv_linear(out: Dict, prefix: str, dense: Dict) -> None:
    out[prefix + ".weight"] = np.asarray(dense["kernel"]).T
    if "bias" in dense:
        out[prefix + ".bias"] = np.asarray(dense["bias"])


def _inv_ln(out: Dict, prefix: str, ln: Dict) -> None:
    out[prefix + ".weight"] = np.asarray(ln["scale"])
    out[prefix + ".bias"] = np.asarray(ln["bias"])


_ADAPTER = "siglip_adapter"  # the reference's peft adapter name


def convert_bifold_inverse(params: Dict) -> Dict[str, Any]:
    """SigLip / SiglipSequential params tree -> reference state-dict names."""
    params = dict(params)
    if "clip_encoder" in params or any(k.startswith("enc0_") for k in params):
        raise NotImplementedError(
            "the PyTorch port serves the SigLIP families only")
    out: Dict[str, Any] = {}
    sig = params["siglip_model"]
    vm, tm = sig["vision_model"], sig["text_model"]
    lora = any("base" in blk["attn"][p]
               for blk in _unstack_blocks(vm["encoder"])
               for p in ("q_proj", "v_proj"))
    root = "siglip_model.model." if lora else "siglip_model."

    pk = np.asarray(vm["patch_embedding"]["kernel"])  # (H, W, in, out)
    out[root + "vision_model.embeddings.patch_embedding.weight"] = \
        pk.transpose(3, 2, 0, 1)
    out[root + "vision_model.embeddings.patch_embedding.bias"] = \
        np.asarray(vm["patch_embedding"]["bias"])
    out[root + "vision_model.embeddings.position_embedding.weight"] = \
        np.asarray(vm["position_embedding"])
    _inv_ln(out, root + "vision_model.post_layernorm", vm["post_layernorm"])
    out[root + "text_model.embeddings.token_embedding.weight"] = \
        np.asarray(tm["token_embedding"]["embedding"])
    out[root + "text_model.embeddings.position_embedding.weight"] = \
        np.asarray(tm["position_embedding"])
    _inv_ln(out, root + "text_model.final_layer_norm", tm["final_layer_norm"])

    for tower, src in (("vision_model", vm), ("text_model", tm)):
        for i, blk in enumerate(_unstack_blocks(src["encoder"])):
            p = f"{root}{tower}.encoder.layers.{i}"
            _inv_ln(out, f"{p}.layer_norm1", blk["norm1"])
            _inv_ln(out, f"{p}.layer_norm2", blk["norm2"])
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                d = blk["attn"][proj]
                kp = f"{p}.self_attn.{proj}"
                if "base" in d:       # LoRA wrap (peft semantics)
                    _inv_linear(out, kp + ".base_layer", d["base"])
                    out[f"{kp}.lora_A.{_ADAPTER}.weight"] = np.asarray(d["lora_a"]).T
                    out[f"{kp}.lora_B.{_ADAPTER}.weight"] = np.asarray(d["lora_b"]).T
                else:
                    _inv_linear(out, kp, d)
            _inv_linear(out, f"{p}.mlp.fc1", blk["mlp"]["fc1"])
            _inv_linear(out, f"{p}.mlp.fc2", blk["mlp"]["fc2"])

    for name in ("text_token", "image_token", "context_pos_embedding"):
        if name in params:
            out[name] = np.asarray(params[name])

    pp = params["pick_place"]
    fusion = pp["fusion"]
    out["pick_place.fusion.token_type_embeddings.weight"] = \
        np.asarray(fusion["token_type_embeddings"]["embedding"])
    if "registers" in fusion:
        raise NotImplementedError("fusion registers are not ported")
    for i, blk in enumerate(_unstack_blocks(fusion["transformer_encoder"])):
        if "fc1" not in blk.get("mlp", {}):
            raise NotImplementedError("MoE fusion FFNs have no reference-format "
                                      "equivalent")
        p = f"pick_place.fusion.transformer_encoder.layers.{i}"
        _inv_ln(out, f"{p}.0.norm", blk["norm1"])
        out[f"{p}.0.fn.to_qkv.weight"] = \
            np.asarray(blk["attn"]["to_qkv"]["kernel"]).T
        _inv_linear(out, f"{p}.0.fn.to_out.0", blk["attn"]["out_proj"])
        _inv_ln(out, f"{p}.1.norm", blk["norm2"])
        _inv_linear(out, f"{p}.1.fn.net.0", blk["mlp"]["fc1"])
        _inv_linear(out, f"{p}.1.fn.net.3", blk["mlp"]["fc2"])
    for head in ("pick_decoder", "place_decoder", "left_pick_decoder",
                 "right_pick_decoder", "left_place_decoder",
                 "right_place_decoder"):
        if head not in pp:
            continue
        for j, slot in enumerate((0, 2, 4, 6, 8)):
            conv = pp[head][f"conv{j}"]
            out[f"pick_place.{head}.decoder_net.{slot}.weight"] = \
                np.asarray(conv["kernel"]).T[:, :, None, None]
            out[f"pick_place.{head}.decoder_net.{slot}.bias"] = \
                np.asarray(conv["bias"])
    return out
