"""JAX params tree <-> the reference's torch state dict, numpy only.

The port's own copies of ``convert_bifold`` (bifold_tpu/models/convert.py
:442, with ``convert_siglip`` :83 and its helpers ``_linear``, ``_ln``,
``_wrap_lora``, ``_stack_blocks``, ``_max_index``) and
``convert_bifold_inverse`` (:551-737), for the SigLIP families this port
serves. The keys of the state dict are the names the port's modules carry,
so ``model.load_state_dict(convert_bifold_inverse(params), strict=True)``
loads a JAX-trained or JAX-initialised model into the port, and
``convert_bifold(model.state_dict())`` gives the params tree a JAX
checkpoint holds:

- HF SigLIP towers under ``siglip_model.model.`` when the params carry LoRA
  (peft ``base_layer`` / ``lora_A.<adapter>`` / ``lora_B.<adapter>``), else
  under ``siglip_model.``;
- ``text_token``, ``image_token``, ``context_pos_embedding``;
- the fusion stack as ``pick_place.fusion.transformer_encoder.layers.i.{0,1}``;
- the conv decoder heads at ``decoder_net.{0,2,4,6,8}``.

The inverse also takes ``torch.bfloat16`` leaves (a JAX checkpoint's
precast frozen towers, as :mod:`bifold_tpu_torch.utils.checkpoint` reads
them): it moves them with the same transposes and indexing, as tensors.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["convert_bifold", "convert_siglip", "convert_bifold_inverse"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Dict, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _ln(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _wrap_lora(dense: Dict[str, np.ndarray], lora: bool, rank: int,
               in_dim: int, out_dim: int) -> Dict:
    """Base kernel under LoRADense layout with zero adapters (peft
    semantics: B = 0, the adapter starts as a no-op)."""
    if not lora:
        return dense
    return {"base": dense,
            "lora_a": np.zeros((in_dim, rank), np.float32),
            "lora_b": np.zeros((rank, out_dim), np.float32)}


def _stack_tree(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack_blocks(blocks: list, scan_layers: bool) -> Dict:
    """Per-layer param dicts -> encoder subtree: stacked along a leading
    depth axis under ``blocks/block`` (the JAX Transformer's nn.scan layout,
    used when depth > 1), else unrolled as ``block_i``."""
    if not scan_layers or len(blocks) == 1:
        return {f"block_{i}": b for i, b in enumerate(blocks)}
    return {"blocks": {"block": _stack_tree(blocks)}}


def _max_index(keys, pattern: str) -> int:
    """Highest ``N`` in keys matching ``...{pattern}N...`` + 1 (0 if none)."""
    rx = re.compile(pattern + r"(\d+)")
    hits = [int(m.group(1)) for k in keys for m in [rx.search(k)] if m]
    return max(hits) + 1 if hits else 0


def convert_siglip(sd: Dict, *, layers: int = 12, lora: bool = False,
                   lora_rank: int = 8, scan_layers: bool = True,
                   lora_targets=("q_proj", "v_proj"),
                   lora_values=None) -> Dict:
    """HF SiglipModel state dict -> the ``siglip_model`` params subtree.
    ``lora_values``: optional ``(A, B)`` dicts keyed by the projection path
    (``vision_model.encoder.layers.0.self_attn.q_proj``) holding trained
    peft ``lora_A`` / ``lora_B`` weights."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    out: Dict[str, Any] = {"vision_model": {}, "text_model": {}}

    vm = out["vision_model"]
    patch_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    vm["patch_embedding"] = {
        "kernel": patch_w.transpose(2, 3, 1, 0),
        "bias": _np(sd["vision_model.embeddings.patch_embedding.bias"]),
    }
    vm["position_embedding"] = _np(
        sd["vision_model.embeddings.position_embedding.weight"])
    vm["post_layernorm"] = _ln(sd, "vision_model.post_layernorm")

    tm = out["text_model"]
    tm["token_embedding"] = {
        "embedding": _np(sd["text_model.embeddings.token_embedding.weight"])}
    tm["position_embedding"] = _np(
        sd["text_model.embeddings.position_embedding.weight"])
    tm["final_layer_norm"] = _ln(sd, "text_model.final_layer_norm")

    for tower, dst in (("vision_model", vm), ("text_model", tm)):
        blocks = []
        for i in range(layers):
            p = f"{tower}.encoder.layers.{i}"
            attn = {}
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                dense = _linear(sd, f"{p}.self_attn.{proj}")
                if proj in ("q_proj", "k_proj", "v_proj") and proj in lora_targets:
                    d_in, d_out = dense["kernel"].shape
                    dense = _wrap_lora(dense, lora, lora_rank, d_in, d_out)
                    key = f"{p}.self_attn.{proj}"
                    if lora and lora_values and key in lora_values[0]:
                        dense["lora_a"] = _np(lora_values[0][key]).T  # (in, r)
                        dense["lora_b"] = _np(lora_values[1][key]).T  # (r, out)
                attn[proj] = dense
            blocks.append({
                "norm1": _ln(sd, f"{p}.layer_norm1"),
                "norm2": _ln(sd, f"{p}.layer_norm2"),
                "attn": attn,
                "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"),
                        "fc2": _linear(sd, f"{p}.mlp.fc2")},
            })
        dst["encoder"] = _stack_blocks(blocks, scan_layers)
    return out


def convert_bifold(sd: Dict, *, scan_layers: bool = True) -> Dict:
    """Full SigLip / SiglipSequential state dict (the reference's names,
    which are the port's) -> the JAX params tree: the optionally
    peft-LoRA-wrapped SigLIP towers, the learned modality tokens and
    context positions, the fusion transformer and the ConvDecoder heads.
    Layer counts, LoRA and its rank, and the heads are read from the keys.
    The other families' keys (``clip_encoder.``, ``project.``) raise."""
    if any(k.startswith(("clip_encoder.", "project.")) for k in sd):
        raise NotImplementedError(
            "the PyTorch port converts the SigLIP families only")
    out: Dict[str, Any] = {}

    # SigLIP towers (strip the peft LoraModel wrapper if present)
    tower_sd, lora_a, lora_b = {}, {}, {}
    for k, v in sd.items():
        if not k.startswith("siglip_model."):
            continue
        k = k.removeprefix("siglip_model.").removeprefix("model.")
        if ".lora_A." in k:            # ...q_proj.lora_A.<adapter>.weight
            lora_a[k.split(".lora_A.")[0]] = v
        elif ".lora_B." in k:
            lora_b[k.split(".lora_B.")[0]] = v
        else:
            tower_sd[k.replace(".base_layer.", ".")] = v
    if tower_sd:
        layers = _max_index(tower_sd, r"vision_model\.encoder\.layers\.")
        lora = bool(lora_a)
        rank = _np(next(iter(lora_a.values()))).shape[0] if lora else 8
        out["siglip_model"] = convert_siglip(
            tower_sd, layers=layers, lora=lora, lora_rank=rank,
            scan_layers=scan_layers, lora_values=(lora_a, lora_b))

    for name in ("text_token", "image_token", "context_pos_embedding"):
        if name in sd:
            out[name] = _np(sd[name])

    # fusion: token-type embeddings + pre-norm transformer
    pp: Dict[str, Any] = {}
    if "pick_place.fusion.token_type_embeddings.weight" in sd:
        fusion: Dict[str, Any] = {
            "token_type_embeddings": {
                "embedding": _np(sd["pick_place.fusion.token_type_embeddings.weight"])}
        }
        depth = _max_index(sd, r"pick_place\.fusion\.transformer_encoder\.layers\.")
        blocks = []
        for i in range(depth):
            p = f"pick_place.fusion.transformer_encoder.layers.{i}"
            # reference layer = [PreNorm(Attention), PreNorm(FeedForward)];
            # to_out is Sequential(Linear, Dropout)
            blocks.append({
                "norm1": _ln(sd, f"{p}.0.norm"),
                "attn": {
                    "to_qkv": {"kernel": _np(sd[f"{p}.0.fn.to_qkv.weight"]).T},
                    "out_proj": _linear(sd, f"{p}.0.fn.to_out.0"),
                },
                "norm2": _ln(sd, f"{p}.1.norm"),
                "mlp": {"fc1": _linear(sd, f"{p}.1.fn.net.0"),
                        "fc2": _linear(sd, f"{p}.1.fn.net.3")},
            })
        fusion["transformer_encoder"] = _stack_blocks(blocks, scan_layers)
        if "pick_place.fusion.registers" in sd:
            fusion["registers"] = _np(sd["pick_place.fusion.registers"])
        pp["fusion"] = fusion

    # ConvDecoder heads: 1x1 convs at Sequential slots 0, 2, 4, 6, 8
    heads = ("pick_decoder", "place_decoder", "left_pick_decoder",
             "right_pick_decoder", "left_place_decoder", "right_place_decoder",
             "mask_head")
    for head in heads:
        if f"pick_place.{head}.decoder_net.0.weight" not in sd:
            continue
        dec = {}
        for j, slot in enumerate((0, 2, 4, 6, 8)):
            w = _np(sd[f"pick_place.{head}.decoder_net.{slot}.weight"])
            dec[f"conv{j}"] = {
                "kernel": w[:, :, 0, 0].T,  # (out, in, 1, 1) -> (in, out)
                "bias": _np(sd[f"pick_place.{head}.decoder_net.{slot}.bias"]),
            }
        pp[head] = dec
    if pp:
        out["pick_place"] = pp
    return out


def _arr(x):
    """A leaf as an array: torch tensors (bfloat16 leaves) stay tensors."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _arr(tree)[i]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack_blocks(enc: Dict) -> list:
    """Encoder subtree -> per-layer dicts: depth-stacked ``blocks/block``
    (nn.scan layout) or unrolled ``block_i``."""
    if "blocks" in enc:
        stacked = enc["blocks"]["block"]
        depth = int(_arr(_first_leaf(stacked)).shape[0])
        return [_index_tree(stacked, i) for i in range(depth)]
    keys = sorted((k for k in enc if k.startswith("block_")),
                  key=lambda s: int(s.split("_")[1]))
    return [enc[k] for k in keys]


def _inv_linear(out: Dict, prefix: str, dense: Dict) -> None:
    out[prefix + ".weight"] = _arr(dense["kernel"]).T
    if "bias" in dense:
        out[prefix + ".bias"] = _arr(dense["bias"])


def _inv_ln(out: Dict, prefix: str, ln: Dict) -> None:
    out[prefix + ".weight"] = _arr(ln["scale"])
    out[prefix + ".bias"] = _arr(ln["bias"])


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

    pk = _arr(vm["patch_embedding"]["kernel"])  # (H, W, in, out)
    out[root + "vision_model.embeddings.patch_embedding.weight"] = \
        pk.permute(3, 2, 0, 1) if isinstance(pk, torch.Tensor) else pk.transpose(3, 2, 0, 1)
    out[root + "vision_model.embeddings.patch_embedding.bias"] = \
        _arr(vm["patch_embedding"]["bias"])
    out[root + "vision_model.embeddings.position_embedding.weight"] = \
        _arr(vm["position_embedding"])
    _inv_ln(out, root + "vision_model.post_layernorm", vm["post_layernorm"])
    out[root + "text_model.embeddings.token_embedding.weight"] = \
        _arr(tm["token_embedding"]["embedding"])
    out[root + "text_model.embeddings.position_embedding.weight"] = \
        _arr(tm["position_embedding"])
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
                    out[f"{kp}.lora_A.{_ADAPTER}.weight"] = _arr(d["lora_a"]).T
                    out[f"{kp}.lora_B.{_ADAPTER}.weight"] = _arr(d["lora_b"]).T
                else:
                    _inv_linear(out, kp, d)
            _inv_linear(out, f"{p}.mlp.fc1", blk["mlp"]["fc1"])
            _inv_linear(out, f"{p}.mlp.fc2", blk["mlp"]["fc2"])

    for name in ("text_token", "image_token", "context_pos_embedding"):
        if name in params:
            out[name] = _arr(params[name])

    pp = params["pick_place"]
    fusion = pp["fusion"]
    out["pick_place.fusion.token_type_embeddings.weight"] = \
        _arr(fusion["token_type_embeddings"]["embedding"])
    if "registers" in fusion:
        raise NotImplementedError("fusion registers are not ported")
    for i, blk in enumerate(_unstack_blocks(fusion["transformer_encoder"])):
        if "fc1" not in blk.get("mlp", {}):
            raise NotImplementedError("MoE fusion FFNs have no reference-format "
                                      "equivalent")
        p = f"pick_place.fusion.transformer_encoder.layers.{i}"
        _inv_ln(out, f"{p}.0.norm", blk["norm1"])
        out[f"{p}.0.fn.to_qkv.weight"] = \
            _arr(blk["attn"]["to_qkv"]["kernel"]).T
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
                _arr(conv["kernel"]).T[:, :, None, None]
            out[f"pick_place.{head}.decoder_net.{slot}.bias"] = \
                _arr(conv["bias"])
    return out
